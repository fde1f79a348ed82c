"""Preemption with KV spill and restore on the port against the JAX engine
(tests/test_torch_preempt_zoo.py's case): the int8-KV and GQA+SWA+int8
models, whose spilled payloads are int8 codes and f32 scales, and W4 g32
packed weights."""
import pytest

from test_torch_preempt_zoo import one_torch_thread, preempt_case  # noqa: F401


@pytest.mark.parametrize("name,variant", [
    ("int8-kv", {"kv_cache_bits": 8}),
    ("gqa-swa-int8", {"n_kv_heads": 2, "attn_window": 12,
                      "kv_cache_bits": 8}),
])
def test_preempt_restore_int8_kv_matches_jax(name, variant):
    preempt_case(variant)


def test_preempt_restore_w4_g32_matches_jax(monkeypatch):
    preempt_case({}, quant=(4, 32), monkeypatch=monkeypatch)
