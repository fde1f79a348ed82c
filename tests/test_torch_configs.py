"""The port's copies of ModelConfig, TINY and the CONFIG/SMOKE pairs of
llama3.2-1b, mixtral-8x22b, qwen2-0.5b, chatglm3-6b, granite-20b,
deepseek-v2-lite-16b, mamba2-2.7b, jamba-1.5-large-398b, whisper-medium
and internvl2-2b equal the JAX package's field for field, on the fields
the port keeps (``moe_impl`` included: both take the shard_map dispatch
only under a mesh with a "model" axis)."""
import dataclasses

import pytest

import repro.configs as jc
from repro.configs import chatglm3_6b as jglm
from repro.configs import deepseek_v2_lite_16b as jds
from repro.configs import granite_20b as jgranite
from repro.configs import internvl2_2b as jvl
from repro.configs import jamba_1_5_large_398b as jjamba
from repro.configs import llama3_2_1b as jllama
from repro.configs import mamba2_2_7b as jmamba
from repro.configs import mixtral_8x22b as jmix
from repro.configs import qwen2_0_5b as jqwen
from repro.configs import whisper_medium as jwhisper
from repro_torch import configs as tc
from repro_torch.configs import chatglm3_6b as tglm
from repro_torch.configs import deepseek_v2_lite_16b as tds
from repro_torch.configs import granite_20b as tgranite
from repro_torch.configs import internvl2_2b as tvl
from repro_torch.configs import jamba_1_5_large_398b as tjamba
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.configs import mamba2_2_7b as tmamba
from repro_torch.configs import mixtral_8x22b as tmix
from repro_torch.configs import qwen2_0_5b as tqwen
from repro_torch.configs import whisper_medium as twhisper
from repro_torch.configs.registry import list_archs
from repro_torch.models.config import LayerSpec, ModelConfig


def _same(tcfg, jcfg):
    for f in dataclasses.fields(ModelConfig):
        tv, jv = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("pattern", "prefix_pattern", "enc_pattern"):
            assert [(s.kind, s.mlp, s.cross_attn) for s in tv] == \
                [(s.kind, s.mlp, s.cross_attn) for s in jv]
        elif f.name in ("moe", "mla", "mamba") and tv is not None:
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
    (tqwen.CONFIG, jqwen.CONFIG), (tqwen.SMOKE, jqwen.SMOKE),
    (tglm.CONFIG, jglm.CONFIG), (tglm.SMOKE, jglm.SMOKE),
    (tgranite.CONFIG, jgranite.CONFIG), (tgranite.SMOKE, jgranite.SMOKE),
    (tc.get_smoke_config("granite-20b"), jc.get_smoke_config("granite-20b")),
    (tds.CONFIG, jds.CONFIG), (tds.SMOKE, jds.SMOKE),
    (tc.get_smoke_config("deepseek-v2-lite-16b"),
     jc.get_smoke_config("deepseek-v2-lite-16b")),
    (tmamba.CONFIG, jmamba.CONFIG), (tmamba.SMOKE, jmamba.SMOKE),
    (tc.get_smoke_config("mamba2-2.7b"), jc.get_smoke_config("mamba2-2.7b")),
    (tjamba.CONFIG, jjamba.CONFIG), (tjamba.SMOKE, jjamba.SMOKE),
    (tc.get_smoke_config("jamba-1.5-large-398b"),
     jc.get_smoke_config("jamba-1.5-large-398b")),
    (twhisper.CONFIG, jwhisper.CONFIG), (twhisper.SMOKE, jwhisper.SMOKE),
    (tc.get_config("whisper-medium"), jc.get_config("whisper-medium")),
    (tc.get_smoke_config("whisper-medium"),
     jc.get_smoke_config("whisper-medium")),
    (tvl.CONFIG, jvl.CONFIG), (tvl.SMOKE, jvl.SMOKE),
    (tc.get_config("internvl2-2b"), jc.get_config("internvl2-2b")),
])
def test_configs_match_jax(pair):
    _same(*pair)


def test_model_config_defaults_match_jax():
    from repro.models.config import ModelConfig as JaxModelConfig
    _same(ModelConfig(), JaxModelConfig())


def test_unported_features_refused():
    with pytest.raises(NotImplementedError):
        tc.TINY.replace(pos_emb="sinusoidal").validate()
    tc.TINY.validate()


@pytest.mark.parametrize("change", [
    dict(attention="linear"), dict(enc_dec=True), dict(frontend="video"),
    dict(pattern=(LayerSpec(kind="mamba"),)), dict(norm="groupnorm"),
    dict(act="relu"), dict(rope="yarn"),
])
def test_other_unported_features_refused(change):
    # a mamba layer and an enc-dec model are ported: a mamba layer without
    # cfg.mamba, or an enc-dec model without an encoder, is an error of the
    # config, as in the JAX package
    exc = (ValueError if "pattern" in change or "enc_dec" in change
           else NotImplementedError)
    with pytest.raises(exc):
        tc.TINY.replace(**change).validate()


@pytest.mark.parametrize("name", ["qwen2-0.5b", "chatglm3-6b",
                                  "granite-20b"])
def test_dense_variants_accepted(name):
    """LayerNorm, GELU, half and no RoPE, learned positions and biases
    pass ``validate``, and the launcher's --arch lists each arch."""
    assert name in list_archs()
    tc.get_config(name).validate()
    tc.get_smoke_config(name).validate()


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b"])
def test_mla_accepted(name):
    """MLA with its config, the unstacked dense first layer and a shared
    expert pass ``validate``; the launcher's --arch lists the arch; the
    layer count and order are the JAX package's; MLA without ``cfg.mla``
    is an error of the config, as in the JAX package."""
    assert name in list_archs()
    cfg = tc.get_config(name)
    cfg.validate()
    tc.get_smoke_config(name).validate()
    jcfg = jc.get_config(name)
    assert cfg.n_layers == jcfg.n_layers == 27
    assert [(s.kind, s.mlp) for s in cfg.all_layer_specs()] == \
        [(s.kind, s.mlp) for s in jcfg.all_layer_specs()]
    with pytest.raises(ValueError, match="cfg.mla"):
        cfg.replace(mla=None).validate()


@pytest.mark.parametrize("name", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_ssm_and_hybrid_accepted(name):
    """Mamba2 blocks, mlp="none" and attention/mamba interleaves pass
    ``validate``; the launcher's --arch lists each arch; the layer kinds
    and order are the JAX package's; a mamba layer without ``cfg.mamba``
    is an error of the config, as in the JAX package."""
    assert name in list_archs()
    cfg = tc.get_config(name)
    cfg.validate()
    tc.get_smoke_config(name).validate()
    jcfg = jc.get_config(name)
    assert cfg.n_layers == jcfg.n_layers
    assert [(s.kind, s.mlp) for s in cfg.all_layer_specs()] == \
        [(s.kind, s.mlp) for s in jcfg.all_layer_specs()]
    with pytest.raises(ValueError, match="cfg.mamba"):
        cfg.replace(mamba=None).validate()


@pytest.mark.parametrize("name", ["whisper-medium", "internvl2-2b"])
def test_encdec_and_vlm_accepted(name):
    """The encoder-decoder (whisper: an encoder stack, decoder layers with
    cross-attention, an audio frontend stub) and the vision frontend stub
    (InternVL2) pass ``validate``; the launcher's --arch lists each arch;
    the decoder's and the encoder's layer kinds and order are the JAX
    package's. Sinusoidal position embeddings stay refused."""
    assert name in list_archs()
    cfg = tc.get_config(name)
    cfg.validate()
    tc.get_smoke_config(name).validate()
    jcfg = jc.get_config(name)
    assert cfg.n_layers == jcfg.n_layers == 24
    for field in ("all_layer_specs", "enc_pattern"):
        got, want = getattr(cfg, field), getattr(jcfg, field)
        got, want = (got(), want()) if callable(got) else (got, want)
        assert [(s.kind, s.mlp, s.cross_attn) for s in got] == \
            [(s.kind, s.mlp, s.cross_attn) for s in want]
    assert cfg.n_enc_repeats == jcfg.n_enc_repeats == (
        24 if name == "whisper-medium" else 0)
    with pytest.raises(NotImplementedError, match="sinusoidal"):
        cfg.replace(pos_emb="sinusoidal").validate()


@pytest.mark.parametrize("change", [dict(n_enc_repeats=0),
                                    dict(enc_pattern=())])
def test_encdec_without_an_encoder_is_a_config_error(change):
    """The JAX package asserts an encoder on an enc-dec config
    (``ModelConfig.validate``); the port raises its config error."""
    cfg = tc.get_smoke_config("whisper-medium")
    with pytest.raises(ValueError, match="needs an encoder"):
        cfg.replace(**change).validate()
    with pytest.raises(AssertionError):
        jc.get_smoke_config("whisper-medium").replace(**change).validate()
