"""Package rules of the port: no JAX at run time, no quiet CPU fallback, and
the deploy transform's per-channel fallback as in the JAX package."""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.quant.deploy import quantize_params_for_serving as jquant
from repro.models.transformer import init_lm as jinit
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.checkpoint.store import load_tree, save_tree
from repro_torch.core.quant.deploy import quantize_params_for_serving
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.launch import train as train_launcher
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import ContinuousEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_port_has_files():
    assert len(PORT_FILES) > 20 and (ROOT / "chip_smoke.py").exists()


def test_entry_points_refuse_cpu_without_asking(monkeypatch, tmp_path):
    """Without CUDA, an entry point left at its default device raises; it
    never drops to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tc.get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lm(cfg, seed=0)
    params = init_lm(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize_params_for_serving(cfg, params, bits=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    save_tree(str(tmp_path / "ck"), params)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_tree(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launcher.main(["--ckpt-dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()
    ContinuousEngine(cfg, params, device="cpu")
    load_tree(str(tmp_path / "ck"), device="cpu")


def test_deploy_per_channel_fallback_matches_jax():
    """TINY at group 128: K = 192 and 576 are not multiples of 128, so every
    linear falls back to one scale group per channel, as in the JAX
    package."""
    jp = jquant(jc.TINY, jinit(jc.TINY, jax.random.PRNGKey(0)), bits=4,
                group_size=128)
    tp = quantize_params_for_serving(
        tc.TINY, params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jinit(jc.TINY, jax.random.PRNGKey(0))),
            device="cpu"), bits=4, group_size=128, device="cpu")
    for sub in ("attn", "mlp"):
        for name, jlin in jp["stack"]["p0"][sub].items():
            w = tp["stack"]["p0"][sub][name]["w"]
            assert isinstance(w, QuantizedTensor)
            assert w.group_size == jlin["w"].group_size == -1
            assert tuple(w.scale.shape) == tuple(jlin["w"].scale.shape)
            assert w.scale.shape[1] == 1
    assert not isinstance(tp["embed"]["w"], QuantizedTensor)
