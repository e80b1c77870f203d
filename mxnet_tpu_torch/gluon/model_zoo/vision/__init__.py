"""`gluon.model_zoo.vision` of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): every model of JAX's
zoo under the same names, and `get_model` with JAX's alias table."""
from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from .others import *  # noqa: F401,F403
from . import resnet as _resnet_mod
from . import others as _others_mod

__all__ = list(_resnet_mod.__all__) + list(_others_mod.__all__) + \
    ["get_model"]

_models = {}
for _mod in (_resnet_mod, _others_mod):
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        if callable(_obj) and _name[0].islower():
            _models[_name] = _obj

# the reference registry's spellings ('inceptionv3', width-dotted names)
_ALIASES = {
    "inceptionv3": "inception_v3",
    "mobilenetv2_1.0": "mobilenet_v2_1_0",
    "mobilenetv2_0.75": "mobilenet_v2_0_75",
    "mobilenetv2_0.5": "mobilenet_v2_0_5",
    "mobilenetv2_0.25": "mobilenet_v2_0_25",
    "mobilenet1.0": "mobilenet1_0",
    "mobilenet0.75": "mobilenet0_75",
    "mobilenet0.5": "mobilenet0_5",
    "mobilenet0.25": "mobilenet0_25",
    "squeezenet1.0": "squeezenet1_0",
    "squeezenet1.1": "squeezenet1_1",
}
for _alias, _target in _ALIASES.items():
    _models[_alias] = _models[_target]


def get_model(name, **kwargs):
    """The zoo's model `name` (case-insensitive), built with `kwargs`."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"model {name!r} is not in the zoo; available: "
            f"{sorted(_models)}")
    return _models[name](**kwargs)
