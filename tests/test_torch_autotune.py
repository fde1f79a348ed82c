"""The port's launch-plan tuner (``repro_torch.kernels.autotune``), its
choice spaces (``kernels/template.py``) and its flags
(``repro_torch.debug_flags``) on the CPU: each case of
``tests/test_autotune.py`` on the port, the fixed plans with no cache
set (at the shapes of PERF.md's kernel table among others), the keys
against the JAX package's, and the measured search through an injected
launcher and timer, since the card is not here."""
import json
from pathlib import Path

import pytest
import torch

from repro.kernels import autotune as jtune
from repro_torch import debug_flags
from repro_torch.kernels import autotune, build, template
from repro_torch.kernels import dequant_matmul as dq
from repro_torch.kernels import expert_dequant_matmul as edq
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

ENV = ("RTORCH_AUTOTUNE", "RTORCH_AUTOTUNE_CACHE", "RTORCH_DEBUG",
       "RTORCH_SANITIZE")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Each test starts and ends with no flag set and a cold tuner."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    autotune.reset()
    yield
    autotune.reset()


def _groups(k, gs):
    return 1 if gs == -1 else k // gs


def _fixed(kind, m, k, n, bits, gs, experts=1):
    g = _groups(k, gs)
    if kind.startswith("expert_"):
        return edq.plan(experts, m, k, n, bits, g,
                        x_bytes=1 if kind.endswith("w8a8") else 4)
    return dq.plan(m, k, n, bits, g, int8=kind == "w8a8")


SHAPES = [(1, 128, 256, 4, 32), (64, 256, 512, 2, -1), (9, 128, 128, 8, 64),
          (200, 1024, 512, 4, 128)]
KINDS = ("dequant", "expert_dequant", "w8a8", "expert_w8a8")
# (S, KVH, W, page, rows, hd, hd_v, pool type) of paged reads: llama's decode
# (8 slots, GQA 32/8, hd 64, 20 pages of 16), its verify at m_rows 5,
# Mixtral's window read, granite's MQA 48/1
PAGED = [(8, 8, 20, 16, 4, 64, 64, "f32"), (8, 8, 20, 16, 4, 64, 64, "int8"),
         (8, 8, 20, 16, 20, 64, 64, "f32"),
         (8, 8, 288, 16, 6, 128, 128, "f32"),
         (8, 1, 20, 16, 48, 128, 128, "int8"),
         # bf16 pools (the dry run's and a bf16 model's): llama's decode
         # read and Mixtral's window
         (8, 8, 20, 16, 4, 64, 64, "bf16"),
         (8, 8, 288, 16, 6, 128, 128, "bf16")]


# ------------------------------------------------------- the fixed plans

def _resolved(kind, m, k, n, bits, gs, experts=1):
    name = {v: k_ for k_, v in autotune.KINDS.items()}[kind]
    if kind.startswith("expert_"):
        return autotune.expert_plan(name, experts, m, k, n, bits,
                                    _groups(k, gs))
    return autotune.dense_plan(name, m, k, n, bits, _groups(k, gs))


def test_cold_cache_resolution_is_the_fixed_planners():
    """Default mode with no cache resolves every class from the fixed
    planners, identically on repeat calls."""
    for kind in KINDS:
        for m, k, n, bits, gs in SHAPES:
            for e in ((1,) if not kind.startswith("expert_") else (1, 8)):
                want = _fixed(kind, m, k, n, bits, gs, e)
                got = _resolved(kind, m, k, n, bits, gs, e)
                assert got == want
                assert _resolved(kind, m, k, n, bits, gs, e) == got
    for shape in PAGED:
        assert autotune.paged_split(*shape) == pa.plan_paged(*shape)


def test_paged_key_has_a_class_per_pool_type():
    """The paged key's pool class is "f32", "int8" or "bf16" (the JAX
    package's bf16 and int8 classes, and the port's f32), named by its
    string only; a bf16 ring holds half an f32 one's bytes."""
    keys = {kv: autotune.paged_key(8, 8, 20, 16, 4, 64, 64, kv)
            for kv in ("f32", "int8", "bf16")}
    assert [keys[kv].rsplit(":", 1)[1] for kv in ("f32", "int8", "bf16")] \
        == ["kvf32", "kvint8", "kvbf16"]
    from repro.kernels import ops as jops
    assert "kv" + jops._kv_dtype(None) == keys["bf16"].rsplit(":", 1)[1]
    assert "kv" + jops._kv_dtype(object()) == keys["int8"].rsplit(":", 1)[1]
    f32 = pa.geometry(4, 128, 128, 288, "f32")
    b16 = pa.geometry(4, 128, 128, 288, "bf16")
    assert b16.smem < f32.smem and b16.rc == f32.rc
    for kv in ("f16", False, True):
        with pytest.raises(ValueError):
            pa.kv_kind(kv)


# the shapes of PERF.md §6's kernel table, as (kernel, shape, bits, group):
# kernel 1 and 3 (M, K, N), kernels 4 and 5 (E, C, K, N)
PERF_SHAPES = [
    ("dequant_matmul", (8, 2048, 8192), 4, 128),
    ("dequant_matmul", (512, 2048, 8192), 4, 128),
    ("dequant_matmul", (8, 896, 4864), 4, 128),
    ("dequant_matmul", (8, 13696, 4096), 4, 128),
    ("dequant_matmul", (8, 10944, 2048), 4, -1),
    ("dequant_matmul", (256, 10944, 2048), 4, -1),
    ("dequant_matmul", (8, 2048, 576), 4, 128),
    ("dequant_matmul", (8, 2560, 10576), 4, 128),
    ("dequant_matmul", (256, 2560, 10576), 4, 128),
    ("dequant_matmul", (8, 5120, 2560), 4, 128),
    ("dequant_matmul", (12000, 1024, 4096), 4, 128),
    ("dequant_matmul", (16384, 2048, 8192), 4, 128),
    ("dequant_matmul", (256, 192, 576), 2, 64),
    ("dequant_matmul", (8, 2048, 256), 4, 128),
    ("w8a8_matmul", (8, 2048, 8192), 4, -1),
    ("w8a8_matmul", (512, 2048, 8192), 4, -1),
    ("w8a8_matmul", (8, 6144, 24576), 4, -1),
    ("w8a8_matmul", (8, 2560, 10576), 4, -1),
    ("w8a8_matmul", (512, 2048, 8192), 4, 128),
    ("expert_dequant_matmul", (8, 8, 6144, 16384), 4, 128),
    ("expert_dequant_matmul", (64, 8, 2048, 1408), 4, 128),
    ("expert_dequant_matmul", (64, 32, 2048, 1408), 4, 128),
    ("expert_dequant_matmul", (16, 8, 8192, 24576), 4, 128),
    ("expert_dequant_matmul", (8, 200, 6144, 16384), 4, -1),
    ("expert_w8a8_matmul", (8, 8, 6144, 16384), 4, -1),
    ("expert_w8a8_matmul", (64, 8, 2048, 1408), 4, 128),
    ("expert_w8a8_matmul", (64, 8, 1408, 2048), 4, -1),
]


@pytest.mark.parametrize("kernel,shape,bits,gs", PERF_SHAPES)
def test_no_cache_plans_are_the_fixed_planners(kernel, shape, bits, gs):
    """With no flag and no cache set, the plan ``run`` / ``launch`` get at
    each shape of the kernel table is the fixed planner's, and it is the
    plan its choice rebuilds."""
    k, n = shape[-2:]
    g = _groups(k, gs)
    if kernel.startswith("expert_"):
        e, c = shape[:2]
        xb = 1 if kernel == "expert_w8a8_matmul" else 4
        want = edq.plan(e, c, k, n, bits, g, x_bytes=xb)
        assert autotune.expert_plan(kernel, e, c, k, n, bits, g) == want
        assert template.valid_expert(template.expert_choice(want), e, c, k,
                                     n, bits, g, x_bytes=xb) == want
    else:
        m = shape[0]
        int8 = kernel == "w8a8_matmul"
        want = dq.plan(m, k, n, bits, g, int8=int8)
        assert autotune.dense_plan(kernel, m, k, n, bits, g) == want
        assert template.valid_dense(template.dense_choice(want), m, k, n,
                                    bits, g, int8=int8) == want


@pytest.mark.parametrize("shape", PAGED)
def test_no_cache_paged_split_is_plan_paged(shape):
    assert autotune.paged_split(*shape) == pa.plan_paged(*shape)
    assert template.valid_paged(template.paged_choice(pa.plan_paged(*shape)),
                                *shape) == pa.plan_paged(*shape)


def test_mode_zero_ignores_a_warm_cache(tmp_path, monkeypatch):
    """RTORCH_AUTOTUNE=0 pins the fixed planners even when a valid warm
    entry exists."""
    path = str(tmp_path / "tune.json")
    key = autotune.matmul_key("dequant", 4, 256, 256, 4, 64)
    autotune.save_cache(path, {key: {"body": dq.TILE, "splits": 2}})
    monkeypatch.setenv("RTORCH_AUTOTUNE_CACHE", path)
    monkeypatch.setenv("RTORCH_AUTOTUNE", "0")
    assert autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 4) == \
        dq.plan(4, 256, 256, 4, 4, int8=False)
    # resolved plans stay, as a JAX variant stays compiled, until reset
    monkeypatch.setenv("RTORCH_AUTOTUNE", "")
    assert autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 4) == \
        dq.plan(4, 256, 256, 4, 4, int8=False)
    autotune.reset()
    tuned = autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 4)
    assert (tuned.body, tuned.splits) == (dq.TILE, 2)


def test_validators_hold_the_planners_constraints():
    """The counterpart of the JAX tuner's per-channel block rule: a tuned
    choice is held to the constraints the fixed planners keep. The tile
    takes no scale group short of a whole 64-row stage; the W8A8 int32
    guard stays in force whatever the splits; a split past K is empty;
    a capacity tile must fit shared memory; n_split is 1-8."""
    # group 16: only the streaming body takes it
    assert template.valid_dense({"body": dq.TILE, "splits": 1}, 8, 2048,
                                2048, 4, 128, int8=False) is None
    assert template.valid_dense({"body": dq.STREAM, "splits": 1}, 8, 2048,
                                2048, 4, 128, int8=False) is not None
    # 127 x 127 x 2^18 rows per int32 sum could overflow, at any plan
    k = 1 << 18
    with pytest.raises(ValueError, match="overflow"):
        dq.plan(8, k, 256, 8, 1, int8=True)
    for body in (dq.STREAM, dq.TILE):
        assert template.valid_dense({"body": body, "splits": 64}, 8, k, 256,
                                    8, 1, int8=True) is None
    # K 256 holds two 128-row stages: a third split would be empty
    assert template.valid_dense({"body": dq.STREAM, "splits": 2}, 8, 256,
                                256, 4, 1, int8=False).splits == 2
    assert template.valid_dense({"body": dq.STREAM, "splits": 3}, 8, 256,
                                256, 4, 1, int8=False) is None
    # malformed choices
    for bad in ({"body": 2, "splits": 1}, {"body": dq.STREAM},
                {"body": "0", "splits": 1}, {"body": True, "splits": 1},
                None, [0, 1]):
        assert template.valid_dense(bad, 8, 256, 256, 4, 1,
                                    int8=False) is None
    # expert: a capacity tile outside CAPACITY_TILES, splits past the grid
    assert template.valid_expert({"nt": 3, "splits": 1}, 8, 8, 6144, 16384,
                                 4, 48, x_bytes=4) is None
    assert template.valid_expert({"nt": 1, "splits": 65535 // 8 + 1}, 8, 8,
                                 6144, 16384, 4, 48, x_bytes=4) is None
    assert template.valid_expert({"nt": 4, "splits": 4}, 8, 8, 6144, 16384,
                                 4, 48, x_bytes=4) is not None
    # paged: 1-8 blocks, and the shape's shared memory must fit
    shape = PAGED[0]
    assert [template.valid_paged({"n_split": n}, *shape)
            for n in (0, 1, 8, 9)] == [None, 1, 8, None]
    assert template.valid_paged({"n_split": 1}, 8, 8, 20, 16, 4, 64, 256,
                                False) is None


def test_candidates_start_at_the_fixed_choice_and_are_valid():
    for m, k, n, bits, g, int8 in ((8, 2048, 8192, 4, 16, False),
                                   (512, 2048, 8192, 4, 1, True),
                                   (16384, 1024, 4096, 4, 8, False),
                                   (8, 2560, 10576, 4, 20, False)):
        cands = template.dense_candidates(m, k, n, bits, g, int8=int8)
        assert cands[0] == template.dense_choice(dq.plan(m, k, n, bits, g,
                                                         int8=int8))
        assert len({json.dumps(c, sort_keys=True) for c in cands}) == \
            len(cands)
        assert all(template.valid_dense(c, m, k, n, bits, g, int8=int8)
                   for c in cands)
        # the streaming body is searched up to the dense sweep's 512 rows
        assert (m <= template.STREAM_SEARCH_MAX_M) == any(
            c["body"] == dq.STREAM for c in cands[1:])
    cands = template.expert_candidates(64, 8, 2048, 1408, 4, 16, x_bytes=4)
    assert cands[0] == template.expert_choice(edq.plan(64, 8, 2048, 1408,
                                                       4, 16, x_bytes=4))
    assert all(template.valid_expert(c, 64, 8, 2048, 1408, 4, 16, x_bytes=4)
               for c in cands)
    cands = template.paged_candidates(*PAGED[0])
    assert cands[0]["n_split"] == pa.plan_paged(*PAGED[0])
    assert sorted(c["n_split"] for c in cands) == list(range(1, 9))


def test_template_version_hashes_the_sources_and_planners():
    here = Path(template.__file__).resolve().parent
    want = build.source_hash(sorted((here / "csrc").iterdir())
                             + [here / m for m in template.PLANNER_MODULES])
    assert template.TEMPLATE_VERSION == want and len(want) == 16
    # the libraries' names keep their hash of source, headers and flags
    lib = build.library_path("paged_attention").name
    assert lib.startswith("libpaged_attention-") and lib.endswith(".so")


def test_reset_clears_resolved_plans_and_the_dense_planner_cache():
    autotune.dense_plan("dequant_matmul", 8, 2048, 2048, 4, 16)
    assert dq.plan.cache_info().currsize > 0 and autotune._state["plans"]
    autotune.reset()
    assert dq.plan.cache_info().currsize == 0
    assert autotune._state["plans"] == {}


# ------------------------------------------------------- shape-class keys

def test_m_bucket_collapses_decode_and_pow2():
    assert [autotune.m_bucket(m) for m in (1, 3, 8)] == [8, 8, 8]
    assert autotune.m_bucket(9) == 16
    assert autotune.m_bucket(16) == 16
    assert autotune.m_bucket(17) == 32
    assert all(autotune.m_bucket(m) == jtune.m_bucket(m)
               for m in range(1, 4097))


def test_shape_class_keys():
    for m in range(1, 4097):
        for kind in KINDS:
            assert (autotune.matmul_key(kind, m, 2048, 8192, 4, 128)
                    == jtune.matmul_key(kind, m, 2048, 8192, 4, 128))
    k1 = autotune.matmul_key("dequant", 1, 256, 512, 4, 32)
    k8 = autotune.matmul_key("dequant", 8, 256, 512, 4, 32)
    k9 = autotune.matmul_key("dequant", 9, 256, 512, 4, 32)
    assert k1 == k8 and k8 != k9                       # decode class
    assert autotune.matmul_key("w8a8", 1, 256, 512, 4, 32) != k1
    # the paged key carries every input of plan_paged
    base = PAGED[0]
    keys = {autotune.paged_key(*base)}
    for i in range(len(base)):
        other = list(base)
        other[i] = "int8" if isinstance(other[i], str) else other[i] * 2
        keys.add(autotune.paged_key(*other))
    assert len(keys) == len(base) + 1


# ------------------------------------------------------------ cache files

def test_cache_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path / "tune.json")
    key = autotune.matmul_key("dequant", 4, 256, 256, 4, 64)
    ent = {"body": dq.TILE, "splits": 2}
    autotune.save_cache(path, {key: ent})
    assert autotune.load_cache(path) == {key: ent}
    data = json.loads(Path(path).read_text())
    assert data["version"] == template.TEMPLATE_VERSION
    assert data["device"] == autotune.device_name() == "cpu"
    assert not list(tmp_path.glob("*.tmp"))          # renamed into place
    monkeypatch.setenv("RTORCH_AUTOTUNE_CACHE", path)
    plan = autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 4)
    assert plan == template.valid_dense(ent, 4, 256, 256, 4, 4, int8=False)
    assert plan != dq.plan(4, 256, 256, 4, 4, int8=False)
    # the entry is rebuilt at the call's real M, inside its class
    assert autotune.dense_plan("dequant_matmul", 7, 256, 256, 4, 4) == \
        template.valid_dense(ent, 7, 256, 256, 4, 4, int8=False)
    # shape classes not in the cache still resolve from the planners
    assert autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 8) == \
        dq.plan(4, 256, 256, 4, 8, int8=False)
    assert autotune.paged_split(*PAGED[0]) == pa.plan_paged(*PAGED[0])


def test_missing_cache_file_is_cold(tmp_path, monkeypatch):
    monkeypatch.setenv("RTORCH_AUTOTUNE_CACHE", str(tmp_path / "absent.json"))
    assert autotune.dense_plan("dequant_matmul", 1, 256, 256, 4, 8) == \
        dq.plan(1, 256, 256, 4, 8, int8=False)
    assert not (tmp_path / "absent.json").exists()


def test_stale_template_version_or_other_card_is_ignored(tmp_path, caplog):
    path = str(tmp_path / "tune.json")
    key = autotune.matmul_key("dequant", 4, 256, 256, 4, 64)
    for payload, word in (
            ({"version": "0" * 16, "device": "cpu"}, "template"),
            ({"version": template.TEMPLATE_VERSION,
              "device": "NVIDIA H100 80GB HBM3"}, "measured on")):
        payload["entries"] = {key: {"body": dq.TILE, "splits": 2}}
        Path(path).write_text(json.dumps(payload))
        caplog.clear()
        with caplog.at_level("WARNING"):
            assert autotune.load_cache(path) == {}
        assert word in caplog.text


@pytest.mark.parametrize("content", ["{not json", '["a", "list"]',
                                     '{"version": "x"}'])
def test_corrupt_cache_falls_back(tmp_path, caplog, content, monkeypatch):
    """Corrupt or wrong-shape cache files warn and hand over to the fixed
    planners, never an exception on the serving path."""
    path = str(tmp_path / "tune.json")
    Path(path).write_text(content)
    with caplog.at_level("WARNING"):
        assert autotune.load_cache(path) == {}
    assert "unreadable" in caplog.text or "template" in caplog.text
    monkeypatch.setenv("RTORCH_AUTOTUNE_CACHE", path)
    assert autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 4) == \
        dq.plan(4, 256, 256, 4, 4, int8=False)


def test_invalid_cached_entry_is_revalidated_away(tmp_path, monkeypatch,
                                                  caplog):
    """A hand-edited or stale entry that breaks a constraint never reaches
    a launch: it is dropped with a warning."""
    path = str(tmp_path / "tune.json")
    mk = autotune.matmul_key("dequant", 4, 2048, 2048, 4, 16)
    ek = autotune.matmul_key("expert_dequant", 8, 6144, 16384, 4, 128)
    pk = autotune.paged_key(*PAGED[0])
    autotune.save_cache(path, {mk: {"body": dq.TILE, "splits": 1},
                               ek: {"nt": 3, "splits": 1},
                               pk: {"n_split": 13}})
    monkeypatch.setenv("RTORCH_AUTOTUNE_CACHE", path)
    with caplog.at_level("WARNING"):
        # the tile takes no group of 16 rows (128 groups of K 2048)
        assert autotune.dense_plan("dequant_matmul", 4, 2048, 2048, 4,
                                   128) == dq.plan(4, 2048, 2048, 4, 128,
                                                   int8=False)
        assert autotune.expert_plan("expert_dequant_matmul", 8, 8, 6144,
                                    16384, 4, 48) == edq.plan(
            8, 8, 6144, 16384, 4, 48, x_bytes=4)
        assert autotune.paged_split(*PAGED[0]) == pa.plan_paged(*PAGED[0])
    assert caplog.text.count("violates") == 3


# ------------------------------------------------------- measured search

class FakeCard:
    """The search's launcher and timer on the CPU: a candidate "runs" as
    the kernel's plain version (plus ``skew`` for a plan ``bad`` picks),
    and takes the time ``cost(plan)``."""

    def __init__(self, cost, bad=lambda plan: False, skew=1.0):
        self.cost, self.bad, self.skew = cost, bad, skew
        self.launched = []

    def launch(self, kernel, case, plan):
        self.launched.append(plan)
        if kernel == "paged_attention":
            q, pools, bt, kv_len, m_rows = case.args
            out = ref.paged_attention_ref(
                q, pools["k_pool"], pools["v_pool"], bt, kv_len,
                pools["k_scale_pool"], pools["v_scale_pool"],
                m_rows=m_rows)
        else:
            x, qt = case.args
            out = getattr(ref, kernel + "_ref")(
                x, qt.qw, qt.scale, bits=qt.bits, group_size=qt.group_size,
                k=qt.k)
        return out + self.skew if self.bad(plan) else out

    def time(self, fns):
        out = []
        for fn in fns:
            fn()
            out.append(self.cost(self.launched[-1]))
        return out


def test_measured_mode_persists_and_reuses(tmp_path, monkeypatch):
    """RTORCH_AUTOTUNE=1 measures every candidate, persists the fastest
    under the current template version and card, and the default mode
    then serves it warm without measuring again."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv("RTORCH_AUTOTUNE", "1")
    monkeypatch.setenv("RTORCH_AUTOTUNE_CACHE", path)
    card = FakeCard(lambda p: abs(p.splits - 2) + (p.body == dq.STREAM))
    with autotune.measured_by(card.launch, card.time):
        plan = autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 4)
    m8 = template.dense_candidates(8, 256, 256, 4, 4, int8=False)
    assert len(card.launched) == 2 * len(m8)       # held, then timed
    assert (plan.body, plan.splits) == (dq.TILE, 2)
    data = json.loads(Path(path).read_text())
    assert data["version"] == template.TEMPLATE_VERSION
    key = autotune.matmul_key("dequant", 4, 256, 256, 4, 64)
    assert data["entries"] == {key: {"body": dq.TILE, "splits": 2}}
    monkeypatch.setenv("RTORCH_AUTOTUNE", "")
    autotune.reset()
    card.launched.clear()
    with autotune.measured_by(card.launch, card.time):
        assert autotune.dense_plan("dequant_matmul", 4, 256, 256, 4,
                                   4) == plan
        # another M of the class: rebuilt for its rows, not measured
        assert autotune.dense_plan("dequant_matmul", 2, 256, 256, 4,
                                   4).splits == 2
    assert card.launched == []


def test_measured_mode_expert_and_in_process_without_a_path(monkeypatch):
    """Without a cache path the winner stays in the process; the expert
    search measures at the call's experts and its class's capacity."""
    monkeypatch.setenv("RTORCH_AUTOTUNE", "1")
    card = FakeCard(lambda p: abs(p.splits - 1) + p.nt)
    with autotune.measured_by(card.launch, card.time):
        plan = autotune.expert_plan("expert_w8a8_matmul", 2, 5, 256, 256, 4,
                                    4)
        assert (plan.nt, plan.splits, plan.experts) == (1, 1, 2)
        n = len(card.launched)
        assert autotune.expert_plan("expert_w8a8_matmul", 2, 8, 256, 256, 4,
                                    4).chunks == 1
    assert len(card.launched) == n
    key = autotune.matmul_key("expert_w8a8", 5, 256, 256, 4, 64)
    assert autotune._state["entries"] == {key: {"nt": 1, "splits": 1}}


def test_measured_mode_keeps_the_fixed_plan_within_the_timers_spread(
        monkeypatch):
    """A candidate replaces the fixed plan only if it is MIN_GAIN faster."""
    monkeypatch.setenv("RTORCH_AUTOTUNE", "1")
    fixed = dq.plan(8, 256, 256, 4, 4, int8=False)
    assert autotune.MIN_GAIN == 0.05
    for other, tuned in ((0.96, fixed), (0.9, None)):
        autotune.reset()
        card = FakeCard(lambda p: 1.0 if p == fixed else other)
        with autotune.measured_by(card.launch, card.time):
            plan = autotune.dense_plan("dequant_matmul", 8, 256, 256, 4, 4)
        assert (plan == fixed) == (tuned is not None)


def test_measured_mode_refused_shape_raises_before_any_search(monkeypatch):
    """A shape the kernel refuses (the W8A8 int32 guard) raises from the
    fixed planner, tuned or not, and nothing is measured."""
    monkeypatch.setenv("RTORCH_AUTOTUNE", "1")
    card = FakeCard(lambda p: 0.0)
    with autotune.measured_by(card.launch, card.time):
        with pytest.raises(ValueError, match="overflow"):
            autotune.dense_plan("w8a8_matmul", 8, 1 << 18, 256, 8, 1)
    assert card.launched == []


def test_measured_mode_raises_on_a_candidate_that_disagrees(monkeypatch):
    """A candidate is held against the plain version before it may win; one
    that disagrees is a fault and raises, it is not skipped."""
    monkeypatch.setenv("RTORCH_AUTOTUNE", "1")
    card = FakeCard(lambda p: 0.0, bad=lambda p: p.splits == 2)
    with autotune.measured_by(card.launch, card.time):
        with pytest.raises(AssertionError, match="max \\|err\\|"):
            autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 4)
    # a skew under the tolerance passes
    autotune.reset()
    card = FakeCard(lambda p: 0.0, bad=lambda p: True, skew=1e-9)
    with autotune.measured_by(card.launch, card.time):
        autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 4)


def test_measured_mode_needs_a_card(monkeypatch):
    monkeypatch.setenv("RTORCH_AUTOTUNE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.dense_plan("dequant_matmul", 4, 256, 256, 4, 4)


def test_measured_paged_split(tmp_path, monkeypatch):
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv("RTORCH_AUTOTUNE", "1")
    monkeypatch.setenv("RTORCH_AUTOTUNE_CACHE", path)
    card = FakeCard(lambda n: abs(n - 3))
    shape = (2, 2, 4, 16, 8, 16, 16, "int8")        # m_rows 2 x G 4
    with autotune.measured_by(card.launch, card.time):
        assert autotune.paged_split(*shape, m_rows=2) == 3
    assert sorted(set(card.launched)) == list(range(1, 9))
    data = json.loads(Path(path).read_text())
    assert data["entries"] == {autotune.paged_key(*shape): {"n_split": 3}}


# ----------------------------------------------------------------- flags

def test_flags_parse_and_snapshot(monkeypatch):
    f = debug_flags.flags()
    assert f == debug_flags.Flags(debug=False, sanitize=False, autotune="",
                                  autotune_cache="")
    assert debug_flags.flags() is f                 # unchanged: same object
    monkeypatch.setenv("RTORCH_DEBUG", "1")
    monkeypatch.setenv("RTORCH_SANITIZE", "0")
    monkeypatch.setenv("RTORCH_AUTOTUNE", "1")
    monkeypatch.setenv("RTORCH_AUTOTUNE_CACHE", "/x/tune.json")
    f = debug_flags.flags()
    assert (debug_flags.debug_enabled(), debug_flags.sanitize_enabled(),
            f.autotune, f.autotune_cache) == (True, False, "1",
                                              "/x/tune.json")
    with pytest.raises(AttributeError):
        debug_flags.flags().debug = False


@pytest.mark.parametrize("key,value", [("RTORCH_AUTOTUNE", "2"),
                                       ("RTORCH_AUTOTUNE", "on"),
                                       ("RTORCH_DEBUG", "yes"),
                                       ("RTORCH_SANITIZE", "true")])
def test_flags_refuse_bad_values(monkeypatch, key, value):
    monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match=key):
        debug_flags.flags()


def test_flags_prefix_stays_out_of_the_reference_linters_way():
    """The port's flags are RTORCH_*, not REPRO_*: the JAX package's RL008
    flags a direct REPRO_* read outside repro.debug_flags, and the port's
    own modules lint clean."""
    from repro.analysis.lint import lint_paths

    assert debug_flags.PREFIX == "RTORCH_"
    assert all(k.startswith("RTORCH_") for k in debug_flags._ENV_KEYS)
    src = Path(debug_flags.__file__).resolve().parent
    files = [src / "debug_flags.py", src / "analysis" / "sanitize.py",
             src / "kernels" / "autotune.py", src / "kernels" / "template.py",
             src / "kernels" / "paged_harness.py",
             src / "launch" / "roofline.py"]
    assert lint_paths([str(f) for f in files]) == []
