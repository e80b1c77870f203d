"""`mx.gluon.data.vision` of the port (counterpart of
``mxnet_tpu/gluon/data/vision/``): the MNIST / CIFAR datasets and the
transforms; what decodes or resizes images waits for ROADMAP.md A11
part 2."""
from . import transforms  # noqa: F401
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,  # noqa: F401
                       ImageListDataset,
                       ImageRecordDataset, ImageFolderDataset)
