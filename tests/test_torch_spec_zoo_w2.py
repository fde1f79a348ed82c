"""Greedy self-speculative serving with a W2 draft across the zoo
(dense, GQA, sliding window, int8 KV, a W4 g32 target): tokens,
``spec_stats`` and target forwards equal to the JAX engine's, tokens
equal to the port's own target-only run (helpers in
tests/test_torch_spec_decode.py)."""
import pytest

# one_torch_thread: that file's autouse fixture, active here too
from test_torch_spec_decode import (ZOO, _check_zoo_case,  # noqa: F401
                                    one_torch_thread)


@pytest.mark.parametrize("name,variant,quant", ZOO)
def test_spec_greedy_zoo_w2_matches_jax(name, variant, quant, monkeypatch):
    _check_zoo_case(name, variant, quant, 2, monkeypatch)
