"""Model registry: name -> (config factory, module, seeded init).

Counterpart of the JAX package's ``models/__init__.py`` with the same 47
names (ResUNet 23, SimpleNet 18, PyramidNet 6):

    spec = load_model("SimpleNetBN2C")
    cfg = spec.make_config(in_channels, out_channels, conv1_kernel_size=3,
                           normalize_feature=True, D=3)
    params, state = spec.init_params(torch.Generator().manual_seed(0), cfg)
    net = spec.module(cfg)          # an nn.Module; forward(plan, feats)
    net.load_state_dict(utils.convert.from_jax_params(params, state, cfg))
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import pyramidnet, resunet, simpleunet


class ModelSpec(NamedTuple):
    name: str
    make_config: Callable
    module: Callable
    init_params: Callable


MODELS = {}
for _mod, _cls in ((resunet, resunet.ResUNet), (simpleunet, simpleunet.SimpleNet),
                   (pyramidnet, pyramidnet.PyramidNet)):
    for _name in _mod._VARIANTS:
        MODELS[_name] = ModelSpec(
            name=_name,
            make_config=lambda *a, _m=_mod, _n=_name, **kw: _m.make_config(_n, *a, **kw),
            module=_cls, init_params=_mod.init_params)


def load_model(name: str) -> ModelSpec:
    """A registered model by name; an unknown name raises ``ValueError``."""
    if name not in MODELS:
        raise ValueError(f"model {name} not found; known: {sorted(MODELS)}")
    return MODELS[name]
