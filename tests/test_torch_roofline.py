"""The port's roofline (``repro_torch.launch.roofline``): ``model_flops``
against the JAX package's ``repro.launch.roofline.model_flops`` on every
config of the registry (the port's param shapes from a fake-tensor init,
the JAX ones from ``jax.eval_shape``), ``bound`` at the numbers
``chip_smoke.py`` printed for kernels 1 and 2, the terms of ``roofline``,
and the bytes the collectives count."""
import dataclasses

import jax
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import roofline as jroof
from repro.models.encdec import init_encdec as jinit_encdec
from repro.models.transformer import init_lm as jinit_lm
from repro_torch.configs import registry
from repro_torch.distributed import collectives
from repro_torch.launch import roofline


@dataclasses.dataclass
class Shape:
    kind: str
    global_batch: int
    seq_len: int


SPECS = [Shape("train", 8, 2048), Shape("prefill", 4, 1500),
         Shape("decode", 128, 4096)]


def test_registry_is_the_references():
    assert registry.list_archs() == sorted(jreg.list_archs())


@pytest.mark.parametrize("arch", registry.list_archs())
def test_model_flops_equals_the_references(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    init = jinit_encdec if jcfg.enc_dec else jinit_lm
    jshape = jax.eval_shape(lambda: init(jcfg, jax.random.PRNGKey(0)))
    shapes = roofline.param_shapes(cfg)
    assert roofline.count_params(shapes) == jroof.count_params(jshape)
    for spec in SPECS:
        assert roofline.model_flops(cfg, shapes, spec) == \
            jroof.model_flops(jcfg, jshape, spec)


def test_bound_gives_what_chip_smoke_printed():
    # kernel 1 at its main shape: (8, 2048) f32 x, W4 g128 codes and
    # scales of 2048 x 8192, (8, 8192) f32 out: 0.0028 ms, bytes
    nbytes = 8 * 2048 * 4 + 2048 * 8192 // 2 + 16 * 8192 * 4 + 8 * 8192 * 4
    ms, by = roofline.bound(nbytes, 2.0 * 8 * 2048 * 8192,
                            roofline.BF16_TENSOR_FLOPS)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)
    assert round(ms, 4) == 0.0028
    # whisper's encoder up projection (12000, 1024, 4096): 0.1018 ms,
    # operations
    ms, by = roofline.bound(12000 * 1024 * 4, 2.0 * 12000 * 1024 * 4096,
                            roofline.BF16_TENSOR_FLOPS)
    assert by == "operations" and round(ms, 4) == 0.1018
    assert roofline.bound(0.0, 67e9, roofline.F32_FLOPS) == (1.0,
                                                             "operations")
    assert roofline.bound(3.35e9, 0.0, roofline.INT8_TENSOR_OPS) == (
        1.0, "bytes")


def test_roofline_terms():
    t = roofline.roofline({"flops": 989e12, "bytes accessed": 6.7e12},
                          {"total": 450e9}, chips=2,
                          model_flops_total=989e12)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 1.0)
    assert t.dominant == "memory" and t.step_time_s == 2.0
    assert t.useful_flops_ratio == 0.5
    assert t.roofline_fraction == pytest.approx(0.25)


def test_collective_bytes_count_what_each_call_sent(monkeypatch):
    """All-reduce and all-to-all count their result's bytes, all-gather
    its input's (the JAX package's operand convention)."""
    monkeypatch.setattr(collectives, "_group", lambda axis: (None, 2))
    for fn in ("all_reduce", "all_gather", "all_to_all_single"):
        monkeypatch.setattr(collectives.dist, fn, lambda *a, **k: None)
    collectives.reset_counts()
    x = torch.zeros((4, 8), dtype=torch.float32)
    collectives.all_reduce(x, "model")
    collectives.all_reduce(x, "model", op="max")
    collectives.all_gather(x[:2], "model")
    collectives.all_to_all(x.to(torch.bfloat16), "model")
    got = roofline.collective_bytes()
    assert got == {"all_reduce": 256, "all_gather": 64, "all_to_all": 64,
                   "total": 384,
                   "counts": {"all_reduce": 2, "all_gather": 1,
                              "all_to_all": 1}}
    collectives.reset_counts()
    assert roofline.collective_bytes()["total"] == 0
