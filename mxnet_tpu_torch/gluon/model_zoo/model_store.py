"""The model zoo's local weight store (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``): the official sha1 table and
the ``$MXTPU_HOME/models`` cache layout, without the download.

`get_model_file(name, root)` resolves, in JAX's order:

1. ``{name}.params`` under `root`: a file the user placed wins, unchecked;
2. ``{name}-{short_hash}.params`` under `root` whose sha1 matches the
   table: the reference's hash-stamped cache;
3. any other ``{name}-*.params`` under `root`, used unverified with a
   warning (JAX's offline override).

Where JAX would then download, the port raises `MXNetError` naming the
file it looked for: its runs have no network, and its models start from
a seed.  `load_pretrained` loads the file into a net (``.npz`` weights:
`Block.load_parameters`).
"""
from __future__ import annotations

import glob
import os
import warnings

from ...base import MXNetError
from ..utils import check_sha1

__all__ = ["get_model_file", "load_pretrained", "purge", "short_hash",
           "register_model_sha1", "data_dir"]

# sha1 -> name pairs of the official zoo artifacts (model_store.py:31-66)
_model_sha1 = {name: checksum for checksum, name in [
    ("44335d1f0046b328243b32a26a4fbd62d9057b45", "alexnet"),
    ("f27dbf2dbd5ce9a80b102d89c7483342cd33cb31", "densenet121"),
    ("b6c8a95717e3e761bd88d145f4d0a214aaa515dc", "densenet161"),
    ("2603f878403c6aa5a71a124c4a3307143d6820e9", "densenet169"),
    ("1cdbc116bc3a1b65832b18cf53e1cb8e7da017eb", "densenet201"),
    ("ed47ec45a937b656fcc94dabde85495bbef5ba1f", "inceptionv3"),
    ("9f83e440996887baf91a6aff1cccc1c903a64274", "mobilenet0.25"),
    ("8e9d539cc66aa5efa71c4b6af983b936ab8701c3", "mobilenet0.5"),
    ("529b2c7f4934e6cb851155b22c96c9ab0a7c4dc2", "mobilenet0.75"),
    ("6b8c5106c730e8750bcd82ceb75220a3351157cd", "mobilenet1.0"),
    ("36da4ff1867abccd32b29592d79fc753bca5a215", "mobilenetv2_1.0"),
    ("e2be7b72a79fe4a750d1dd415afedf01c3ea818d", "mobilenetv2_0.75"),
    ("aabd26cd335379fcb72ae6c8fac45a70eab11785", "mobilenetv2_0.5"),
    ("ae8f9392789b04822cbb1d98c27283fc5f8aa0a7", "mobilenetv2_0.25"),
    ("a0666292f0a30ff61f857b0b66efc0228eb6a54b", "resnet18_v1"),
    ("48216ba99a8b1005d75c0f3a0c422301a0473233", "resnet34_v1"),
    ("0aee57f96768c0a2d5b23a6ec91eb08dfb0a45ce", "resnet50_v1"),
    ("d988c13d6159779e907140a638c56f229634cb02", "resnet101_v1"),
    ("671c637a14387ab9e2654eafd0d493d86b1c8579", "resnet152_v1"),
    ("a81db45fd7b7a2d12ab97cd88ef0a5ac48b8f657", "resnet18_v2"),
    ("9d6b80bbc35169de6b6edecffdd6047c56fdd322", "resnet34_v2"),
    ("ecdde35339c1aadbec4f547857078e734a76fb49", "resnet50_v2"),
    ("18e93e4f48947e002547f50eabbcc9c83e516aa6", "resnet101_v2"),
    ("f2695542de38cf7e71ed58f02893d82bb409415e", "resnet152_v2"),
    ("264ba4970a0cc87a4f15c96e25246a1307caf523", "squeezenet1.0"),
    ("33ba0f93753c83d86e1eb397f38a667eaf2e9376", "squeezenet1.1"),
    ("dd221b160977f36a53f464cb54648d227c707a05", "vgg11"),
    ("ee79a8098a91fbe05b7a973fed2017a6117723a8", "vgg11_bn"),
    ("6bc5de58a05a5e2e7f493e2d75a580d83efde38c", "vgg13"),
    ("7d97a06c3c7a1aecc88b6e7385c2b373a249e95e", "vgg13_bn"),
    ("e660d4569ccb679ec68f1fd3cce07a387252a90a", "vgg16"),
    ("7f01cf050d357127a73826045c245041b0df7363", "vgg16_bn"),
    ("ad2f660d101905472b83590b59708b71ea22b2e5", "vgg19"),
    ("f360b758e856f1074a85abd5fd873ed1d98297c3", "vgg19_bn"),
]}



def data_dir() -> str:
    """The cache root: ``$MXTPU_HOME`` (``$MXNET_HOME`` honoured), else
    ``~/.mxnet`` (the reference's spelling)."""
    return os.environ.get("MXTPU_HOME") or os.environ.get("MXNET_HOME") \
        or os.path.join(os.path.expanduser("~"), ".mxnet")


def register_model_sha1(name: str, sha1: str) -> None:
    """Extend the table at run time (private zoos, tests)."""
    _model_sha1[name] = sha1


def short_hash(name: str) -> str:
    if name not in _model_sha1:
        raise ValueError(f"Pretrained model for {name} is not available.")
    return _model_sha1[name][:8]


def get_model_file(name: str, root: str | None = None) -> str:
    """The local path of the weights for `name` under `root` (default
    ``data_dir()/models``); raises `MXNetError` naming the file when none
    is there."""
    root = os.path.expanduser(root or os.path.join(data_dir(), "models"))
    override = os.path.join(root, f"{name}.params")
    if os.path.isfile(override):
        return override
    stamped = sorted(glob.glob(os.path.join(root, f"{name}-*.params")))
    if name in _model_sha1:
        file_path = os.path.join(root, f"{name}-{short_hash(name)}.params")
        if os.path.exists(file_path):
            if check_sha1(file_path, _model_sha1[name]):
                return file_path
            stamped.remove(file_path)     # corrupt: never handed back
        if stamped:
            warnings.warn(f"using local weights {stamped[0]} for {name!r} "
                          "WITHOUT sha1 verification")
            return stamped[0]
        want = file_path
    elif stamped:
        return stamped[0]
    else:
        want = override
    raise MXNetError(
        f"Pretrained weights for {name!r} are not under {root}: place "
        f"{want} (or {override}) there. Nothing is downloaded: the port's "
        "runs have no network, and its models start from a seed.")


def purge(root: str | None = None) -> None:
    """Remove every cached ``.params`` file under `root`."""
    root = os.path.expanduser(root or os.path.join(data_dir(), "models"))
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))


def load_pretrained(net, pretrained: bool, name: str, root=None):
    """`net`, with `name`'s weights loaded when `pretrained`."""
    if pretrained:
        net.load_parameters(get_model_file(name, root), cast_dtype=True)
    return net
