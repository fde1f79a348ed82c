"""The port's copies of ModelConfig, TINY and the llama3.2-1b CONFIG/SMOKE
equal the JAX package's field for field, on the fields the port keeps."""
import dataclasses

import pytest

import repro.configs as jc
from repro.configs import llama3_2_1b as jllama
from repro.configs import mixtral_8x22b as jmix
from repro_torch import configs as tc
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.configs import mixtral_8x22b as tmix
from repro_torch.models.config import ModelConfig


def _same(tcfg, jcfg):
    for f in dataclasses.fields(ModelConfig):
        tv, jv = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "pattern":
            assert [(s.kind, s.mlp) for s in tv] == \
                [(s.kind, s.mlp) for s in jv]
        elif f.name == "moe" and tv is not None:
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        else:
            assert tv == jv, f.name
    assert tcfg.hd == jcfg.hd


@pytest.mark.parametrize("pair", [
    (tc.TINY, jc.TINY), (tllama.CONFIG, jllama.CONFIG),
    (tllama.SMOKE, jllama.SMOKE),
    (tc.get_smoke_config("llama3.2-1b"), jc.get_smoke_config("llama3.2-1b")),
    (tc.get_config("tiny"), jc.get_config("tiny")),
    (tmix.CONFIG, jmix.CONFIG), (tmix.SMOKE, jmix.SMOKE),
    (tc.get_smoke_config("mixtral-8x22b"),
     jc.get_smoke_config("mixtral-8x22b")),
])
def test_configs_match_jax(pair):
    _same(*pair)


def test_model_config_defaults_match_jax():
    from repro.models.config import ModelConfig as JaxModelConfig
    _same(ModelConfig(), JaxModelConfig())


def test_unported_features_refused():
    with pytest.raises(NotImplementedError):
        tc.TINY.replace(norm="layernorm").validate()
    tc.TINY.validate()
