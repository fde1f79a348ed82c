"""The port's dry-run tooling (``launch/{shapes,dryrun,report,hillclimb}``)
against the JAX package's, on the CPU: the cells' input specs and skip
reasons, ``build_cell``'s args leaf by leaf in global shape and dtype
(the JAX side on a 1 x 1 mesh, both at one repeat of the pattern), one
rank's argument bytes at the production meshes against bytes computed
from the JAX package's specs, the report's table on the same records,
the hill-climbing variants, and one ``run_cell`` on a SMOKE config with
every key of the JAX package's record.

Importing the JAX package's dry run sets ``XLA_FLAGS`` (512 host
devices); the variable is restored at once, so no process spawned later
inherits it."""
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import hillclimb as jhill  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

import repro.configs as jc  # noqa: E402
from repro.distributed import partitioning as JP  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro_torch.configs.registry import get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, report, shapes  # noqa: E402

ARCHS = list_archs()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


# --------------------------------------------------------------- (f) shapes

def test_shapes_are_the_references():
    assert {k: tuple(vars(v).values()) for k, v in shapes.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in jshapes.SHAPES.items()}
    assert shapes.WHISPER_ENC_LEN == jshapes.WHISPER_ENC_LEN
    assert shapes.LONG_OK_FAMILIES == jshapes.LONG_OK_FAMILIES


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_skip_reasons_match_jax(arch):
    """Every (arch x shape): the same skip reason, and the same inputs in
    global shape and dtype, at the dry run's bf16 numerics too."""
    for name, shape in shapes.SHAPES.items():
        for bf16 in (False, True):
            tcfg, jcfg = get_config(arch), jc.get_config(arch)
            if bf16:
                tcfg = dryrun.dry_cfg(tcfg, shape.kind)
                jcfg = jdry.dry_cfg(jcfg, shape.kind)
            jshape = jshapes.SHAPES[name]
            assert shapes.skip_reason(tcfg, shape) == \
                jshapes.skip_reason(jcfg, jshape)
            got = shapes.input_specs(tcfg, shape)
            want = jshapes.input_specs(jcfg, jshape)
            assert got.keys() == want.keys()
            for k in got:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype)
                assert got[k].untyped_storage is not None


def test_input_specs_all_cells():
    """tests/test_sharding.py's case on the port's shapes."""
    n_ok, n_skip = 0, 0
    for arch in ["qwen2-0.5b", "whisper-medium", "internvl2-2b",
                 "mamba2-2.7b", "jamba-1.5-large-398b"]:
        cfg = get_config(arch)
        for name, shape in shapes.SHAPES.items():
            if shapes.skip_reason(cfg, shape):
                n_skip += 1
                continue
            specs = shapes.input_specs(cfg, shape)
            assert all(hasattr(v, "shape") for v in specs.values())
            n_ok += 1
    assert n_ok >= 15 and n_skip >= 2


# ----------------------------------------------------------- (g) build_cell

def _flat(tree, prefix=""):
    """(path, shape, dtype name) of every array leaf; a packed weight's
    qw and scale under path#qw / path#scale; leaves that are no array
    (the port's Python int step counter) left out."""
    out = []
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out += _flat(v, f"{prefix}{i}/")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out += _flat(tree[k], f"{prefix}{k}/")
    elif hasattr(tree, "qw") and hasattr(tree, "scale"):
        out += _flat(tree.qw, prefix[:-1] + "#qw/")
        out += _flat(tree.scale, prefix[:-1] + "#scale/")
    elif hasattr(tree, "shape"):
        out.append((prefix[:-1], tuple(tree.shape),
                    str(tree.dtype).split(".")[-1]))
    return out


def _is_prefix_cache(path):
    """A prefix block's cache leaf: the port keeps it as a stack of one
    (leading dim 1, so every pool leaf has its page axis at 1); the JAX
    package's is unstacked."""
    parts = path.split("/")
    return "prefix" in parts and parts[0] in ("2", "3") and \
        parts[parts.index("prefix") - 1] in ("2", "3")


def _layer_cache_path(path):
    """A cache leaf's path without the layer kind: the JAX package nests a
    layer's cache under "attn" or "mamba", the port holds it at the layer
    (but a cross-attention layer's, {"attn", "xattn"} in both)."""
    parts = path.split("/")
    if parts[0] in ("2", "3") and len(parts) > 3 and \
            parts[1] in ("stack", "prefix") and parts[3] in ("attn", "mamba"):
        del parts[3]
    return "/".join(parts)


def _build_pair(arch, shape_name):
    tcfg = get_config(arch).replace(n_repeats=1)
    jcfg = jc.get_config(arch).replace(n_repeats=1)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    _, jargs, jcfg2 = jdry.build_cell(jcfg, shape_name, jmesh)
    mesh = dryrun.shape_mesh(False)
    with dryrun.FakeTensorMode() as mode:
        _, targs, tcfg2 = dryrun.build_cell(tcfg, shape_name, mesh,
                                            mode=mode)
    return targs, jargs, tcfg2, jcfg2


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_args_match_jax(arch):
    """Every cell's args, leaf by leaf in global shape and dtype, equal the
    JAX package's (at one repeat: the leaves are the same at any depth),
    but the port's prefix-block caches (a stack of one)."""
    for name in shapes.SHAPES:
        if shapes.skip_reason(get_config(arch), shapes.SHAPES[name]):
            continue
        targs, jargs, tcfg, jcfg = _build_pair(arch, name)
        assert (tcfg.dtype, tcfg.param_dtype, tcfg.remat) == \
            (jcfg.dtype, jcfg.param_dtype, jcfg.remat)
        got = {_layer_cache_path(p): (s, d) for p, s, d in _flat(targs)}
        want = {_layer_cache_path(p): (s, d) for p, s, d in _flat(jargs)}
        if shapes.SHAPES[name].kind == "train":
            # Adam's step counter: an int32 scalar there, a Python int here
            assert want.pop("1/adam/step") == ((), "int32")
            assert targs[1]["adam"]["step"] == 0
        for p, (s, d) in list(got.items()):
            if _is_prefix_cache(p):
                assert s[0] == 1
                got[p] = (s[1:], d)
        assert got == want, (name, set(got) ^ set(want))


# --------------------------------------------------- (h) argument bytes

def _shard_bytes(shape, dtype, names, mesh, rules):
    spec = JS.spec_for(shape, names, mesh=mesh, rules=rules)
    n = 1
    for dim, axes in zip(shape, spec):
        if axes is None:
            n *= dim
        else:
            flat = (axes,) if isinstance(axes, str) else tuple(axes)
            n *= dim // math.prod(mesh.shape[a] for a in flat)
    return n * np.dtype(dtype).itemsize


def _jax_batch_names(path, leaf):
    base = path.split("/")[-1]
    if base in ("tokens", "labels", "positions"):
        return ("batch",) + (None,) * (leaf.ndim - 1)
    if base in ("frames", "ext_embeds"):
        return ("batch", None, None)
    return (None,) * leaf.ndim


def _jax_rank_bytes(kind, jcfg, jargs, mesh):
    """One rank's bytes of the JAX package's args under its own specs:
    its param rules (the params and Adam's moments), its cache rule
    (``dryrun._cache_names``), its batch rule, on ``mesh``."""
    rules = JP.rules_for_config(jcfg, mesh)
    rules["cache_seq"] = "model"
    total = 0

    def params_of(tree):
        nonlocal total

        def fn(path, leaf, names):
            nonlocal total
            total += _shard_bytes(leaf.shape, leaf.dtype, names, mesh, rules)
            return leaf

        JP._walk(tree, "", fn)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}" if prefix else k)
        else:
            yield prefix, tree

    if kind == "train":
        params, opt, batch = jargs[:3]
        params_of(params)
        params_of(opt["adam"]["m"])
        params_of(opt["adam"]["v"])
        total += 4                                       # adam step
        for p, leaf in leaves(batch):
            total += _shard_bytes(leaf.shape, leaf.dtype,
                                  _jax_batch_names(p, leaf), mesh, rules)
        for leaf in jargs[3:]:
            total += math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        return total
    params_of(jargs[0])
    for i, a in enumerate(jargs[1:]):
        if isinstance(a, dict):
            for p, leaf in leaves(a):
                total += _shard_bytes(leaf.shape, leaf.dtype,
                                      jdry._cache_names(p, leaf), mesh,
                                      rules)
        else:
            name = ("positions" if kind == "decode" and i == len(jargs) - 2
                    else "frames" if len(a.shape) == 3 else "tokens")
            total += _shard_bytes(a.shape, a.dtype,
                                  _jax_batch_names(name, a), mesh, rules)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_argument_bytes_match_jax_specs(arch):
    """One rank's argument bytes at (16, 16) and (2, 16, 16), fsdp as the
    config sets it and set, equal those of the JAX package's specs."""
    for name in ("train_4k", "decode_32k"):
        if shapes.skip_reason(get_config(arch), shapes.SHAPES[name]):
            continue
        targs, jargs, tcfg, jcfg = _build_pair(arch, name)
        kind = shapes.SHAPES[name].kind
        for multi in (False, True):
            mesh = dryrun.shape_mesh(multi)
            fake = FakeMesh(dict(mesh.shape))
            for fsdp in (tcfg.fsdp, not tcfg.fsdp):
                t = dryrun.rank_argument_bytes(
                    kind, tcfg.replace(fsdp=fsdp), targs, mesh,
                    dryrun.cell_rules(tcfg.replace(fsdp=fsdp), mesh, None))
                # the port's prefix caches' stack of one adds no bytes
                j = _jax_rank_bytes(kind, jcfg.replace(fsdp=fsdp), jargs,
                                    fake)
                assert t == j, (name, multi, fsdp)


# ------------------------------------------------------------ (i) report

def _records():
    ok = {"arch": "llama3.2-1b", "shape": "decode_32k", "mesh": "single",
          "status": "ok",
          "roofline": {"compute_s": 3.2e-5, "memory_s": 0.0123,
                       "collective_s": 0.0, "dominant": "memory",
                       "useful_flops_ratio": 0.51,
                       "roofline_fraction": 0.0021},
          "memory": {"peak_bytes": 3.5 * 2 ** 30, "temp_bytes": None}}
    no_peak = dict(ok, arch="chatglm3-6b", memory={"peak_bytes": None,
                                                    "temp_bytes": 12345},
                   roofline=dict(ok["roofline"], useful_flops_ratio=None,
                                 compute_s=2.5, memory_s=0.5e-3))
    return [ok, no_peak,
            {"arch": "qwen2-0.5b", "shape": "long_500k", "mesh": "single",
             "status": "skipped", "reason": "full-attention arch"},
            {"arch": "granite-20b", "shape": "train_4k", "mesh": "single",
             "status": "error", "error": "OutOfMemoryError: " + "x" * 200},
            dict(ok, mesh="multi")]


def test_report_table_matches_jax(tmp_path, capsys):
    recs = _records()
    for mesh in ("single", "multi"):
        assert report.table(recs, mesh) == jreport.table(recs, mesh)
    for v in (None, 0, 1023, 1024, 5.5e6, 3e13, 2e18):
        assert report.fmt_bytes(v) == jreport.fmt_bytes(v)
    for v in (None, 0.0, 3e-7, 2e-4, 0.5, 12.25):
        assert report.fmt_s(v) == jreport.fmt_s(v)
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert report.load(str(tmp_path)) == jreport.load(str(tmp_path))
    report.main(["--dir", str(tmp_path)])
    got = capsys.readouterr().out
    assert "records: 5 (ok=3 skipped=1 err=1)" in got
    assert report.table(report.load(str(tmp_path))) in got


# ---------------------------------------------- (j) hillclimb and run_cell

def test_hillclimb_variants_are_the_references():
    assert hillclimb.VARIANTS == jhill.VARIANTS


OK_KEYS = {"arch", "shape", "mesh", "status", "compile_s", "chips",
           "cost_uncorrected", "memory", "cost", "collectives",
           "collective_counts", "model_flops_total", "roofline", "wall_s"}


def test_run_cell_on_a_smoke_config_has_the_references_keys(tmp_path,
                                                            capsys):
    """``run_cell(device="cpu")`` on llama3.2-1b SMOKE's decode cell (the
    realized run cut to 2 rows): every key of the JAX package's ok record
    and its sub-records, plus ``reduced``; then ``hillclimb`` diffs a
    variant against it."""
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", False, str(tmp_path),
                          device="cpu", smoke=True, batch=2)
    assert rec["status"] == "ok", rec.get("traceback")
    assert OK_KEYS <= set(rec) and "reduced" in rec
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "useful_flops_ratio",
                                    "roofline_fraction"}
    assert set(rec["cost"]) == {"flops", "bytes accessed",
                                "transcendentals"}
    assert rec["reduced"]["batch"] == 2 and rec["chips"] == 256
    assert rec["cost"]["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
    assert rec["collectives"]["total"] == 0
    assert (tmp_path / "llama3.2-1b__decode_32k__single.json").exists()
    hillclimb.main(["--cell", "llama3.2-1b:decode_32k", "--variant",
                    "chunked_decode", "--device", "cpu", "--smoke",
                    "--batch", "2", "--out", str(tmp_path / "perf"),
                    "--base-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "llama3.2-1b decode_32k [chunked_decode] vs baseline:" in out
    assert "peak HBM" in out
