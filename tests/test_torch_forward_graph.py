"""The forward's CUDA graph path (libpll2_tpu_torch/forward_graph.py and
engine.loglikelihood): eligibility, keys, the cache's sightings and
evictions, replay's counters and copies, on the CPU with stand-ins for the
graphs; on the card (marked `cuda`, skipped without one) replayed logL
against eager logL bit for bit, results kept across calls, the sweep's
launch counters, a model changed in place, and the spans of a replay.

On a GPU machine:

    python -m pytest tests/test_torch_forward_graph.py
"""
import dataclasses
import importlib.util
import pathlib
import warnings

import numpy as np
import pytest
import torch

from libpll2_tpu_torch import engine, forward_graph, spans
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.config import PartitionConfig
from libpll2_tpu_torch.constants import AB_LEWIS, AB_NONE
from libpll2_tpu_torch.models.aa import aa_model
from libpll2_tpu_torch.models.gamma import compute_gamma_cats
from libpll2_tpu_torch.tree.generate import random_newick, random_tipchars

COUNTERS = (forward_graph.EAGER, forward_graph.CAPTURE, forward_graph.REPLAY)


@dataclasses.dataclass
class Case:
    cfg: PartitionConfig
    program: engine.TreeProgram
    model: engine.Model
    bl: torch.Tensor
    tipchars: torch.Tensor
    pw: torch.Tensor
    inv: torch.Tensor

    def args(self, bl=None):
        return (self.program, self.cfg, self.model,
                self.bl if bl is None else bl, self.tipchars, self.pw,
                self.inv)


def make_case(device, states=4, per_rate=False, sites=512, tips=24,
              dtype=torch.float32, sweep_mode=None, asc=AB_NONE, pinv=0.0,
              bl_scale=1.0, seed=0, lg=False) -> Case:
    rng = np.random.default_rng(seed)
    tree = T.parse_newick_string(random_newick(tips, rng))
    cfg = PartitionConfig(
        tips=tips, clv_buffers=tree.inner_count, states=states, sites=sites,
        rate_matrices=1, prob_matrices=2 * tips - 3, rate_cats=4,
        scale_buffers=tree.inner_count, per_rate_scalers=per_rate,
        asc_bias=asc, dtype=dtype, use_kernel=True, sweep_mode=sweep_mode)
    program = engine.compile_tree(tree, cfg)
    if lg:
        subst, freqs = (np.atleast_2d(x) for x in aa_model("lg"))
    else:
        subst = [rng.uniform(0.2, 3.0, states * (states - 1) // 2)]
        freqs = [rng.dirichlet(np.full(states, 5.0))]
    model = engine.make_model(subst, freqs, compute_gamma_cats(0.8, 4),
                              prop_invar=[pinv], dtype=torch.float32,
                              device=device)
    raw = random_tipchars(tips, sites, rng, states=states)
    raw[:, :sites // 8] = raw[0, :sites // 8]       # some invariant sites
    tipchars = engine.pad_tipchars(raw, cfg)
    inv = np.full(cfg.sites_padded, -1, np.int32)
    if pinv > 0:
        first = tipchars[0]
        single = (first > 0) & ((first & (first - 1)) == 0)
        same = (tipchars == first).all(axis=0) & single
        inv = np.where(same, np.log2(np.maximum(first, 1)), -1) \
            .astype(np.int32)
    pw = np.zeros(cfg.sites_padded)
    pw[:cfg.sites_alloc] = rng.integers(1, 4, cfg.sites_alloc)
    bl = program.default_branch_lengths * bl_scale
    return Case(cfg, program, model,
                torch.as_tensor(bl, dtype=torch.float32, device=device),
                torch.as_tensor(tipchars, device=device),
                torch.as_tensor(pw, dtype=torch.float32, device=device),
                torch.as_tensor(inv, device=device))


def eager_logl(c: Case, bl):
    """The eager path's logL of the call, outside the cache."""
    view, pmatrix = engine._sweep(c.program, c.cfg, c.model, bl, c.tipchars,
                                  c.pw)
    return engine._root_logl(c.program, c.cfg, c.model, view, pmatrix, c.pw,
                             c.inv)


def counts():
    return {k: getattr(engine.loglikelihood, k) for k in COUNTERS}


def advanced(before):
    return {k: v - before[k] for k, v in counts().items()}


@pytest.fixture(autouse=True)
def fresh_cache():
    engine._graphs.clear()
    yield
    engine._graphs.clear()


# -- eligibility, keys and the cache, on the CPU --------------------------

CUDA = torch.device("cuda", 0)
PLAIN = torch.zeros(3)
NEEDS_GRAD = torch.zeros(3, requires_grad=True)


@pytest.mark.parametrize("case,args,want", [
    ("eligible", (CUDA, None, (128, "fma"), [PLAIN], True, False), True),
    ("cpu device", (torch.device("cpu"), None, (128, "fma"), [PLAIN], True,
                    False), False),
    ("group", (CUDA, object(), (128, "fma"), [PLAIN], True, False), False),
    ("dense choice", (CUDA, None, None, [PLAIN], True, False), False),
    ("grad", (CUDA, None, (128, "fma"), [PLAIN, NEEDS_GRAD], True, False),
     False),
    ("grad off", (CUDA, None, (128, "fma"), [NEEDS_GRAD], False, False),
     True),
    ("numpy input", (CUDA, None, (64, "mma"), [np.zeros(3)], True, False),
     True),
    ("capturing", (CUDA, None, (128, "fma"), [PLAIN], True, True), False),
])
def test_eligible(case, args, want):
    assert forward_graph.eligible(*args) is want


def test_cpu_calls_go_eager():
    c = make_case("cpu")
    before = counts()
    first = engine.loglikelihood(*c.args())
    for _ in range(3):
        assert torch.equal(engine.loglikelihood(*c.args()), first)
    assert advanced(before) == {forward_graph.EAGER: 4,
                                forward_graph.CAPTURE: 0,
                                forward_graph.REPLAY: 0}
    assert not engine._graphs.graphs and not engine._graphs.seen


def key_of(c: Case, model=None, tipchars=None, bl=None):
    model = c.model if model is None else model
    tensors = [getattr(model, f) for f in engine.Model.FIELDS] + \
        [c.tipchars if tipchars is None else tipchars, c.pw, c.inv]
    return forward_graph.key(c.program, c.cfg, torch.device("cpu"), tensors,
                             c.bl if bl is None else bl)


def test_key_equality():
    c = make_case("cpu")
    k = key_of(c)
    assert hash(k) == hash(key_of(c)) and k == key_of(c)
    # new lengths of the same shape and dtype: the same key
    assert key_of(c, bl=c.bl * 1.5) == k
    # a new model object (new tensors), new tipchars, other lengths' shape
    other = engine.make_model(
        [[1.0] * 6], [[0.25] * 4], compute_gamma_cats(0.8, 4),
        dtype=torch.float32, device="cpu")
    assert key_of(c, model=other) != k
    assert key_of(c, tipchars=c.tipchars.clone()) != k
    assert key_of(c, bl=c.bl[:-1]) != k
    assert key_of(c, bl=c.bl.double()) != k
    # another program of the same tree is another key
    again = dataclasses.replace(c, program=engine.compile_tree(
        T.parse_newick_string(random_newick(24, np.random.default_rng(0))),
        c.cfg))
    assert key_of(again) != k


class StandIn:
    """A captured key's stand-in: replays return its name."""

    def __init__(self, name):
        self.name = name


def drive(cache, k, log):
    def eager():
        log.append(("eager", k))
        return "eager"

    def capture():
        log.append(("capture", k))
        return "captured", StandIn(k)

    return cache.call(k, (k,), eager, capture, lambda g: g.name)


def test_cache_sightings_and_lru():
    cache = forward_graph.Cache()
    log = []
    # the first sighting runs eager, the second captures, then replays
    assert drive(cache, "a", log) == ("eager", forward_graph.EAGER)
    assert drive(cache, "a", log) == ("captured", forward_graph.CAPTURE)
    assert drive(cache, "a", log) == ("a", forward_graph.REPLAY)
    assert log == [("eager", "a"), ("capture", "a")]
    # fill the cache past its cap: the least recently used key goes
    keys = [f"k{i}" for i in range(forward_graph.MAX_GRAPHS)]
    for k in keys:
        drive(cache, k, log)
        drive(cache, k, log)
    assert len(cache.graphs) == forward_graph.MAX_GRAPHS
    assert "a" not in cache.graphs and "k0" in cache.graphs
    # touching k0 makes k1 the oldest; one more capture evicts k1
    assert drive(cache, "k0", log)[1] == forward_graph.REPLAY
    drive(cache, "new", log)
    drive(cache, "new", log)
    assert "k1" not in cache.graphs and "k0" in cache.graphs
    # an evicted key starts over: eager, then captured again
    assert drive(cache, "a", log)[1] == forward_graph.EAGER
    assert drive(cache, "a", log)[1] == forward_graph.CAPTURE
    # the keys seen once are an LRU of the same size
    for i in range(forward_graph.MAX_GRAPHS + 1):
        drive(cache, f"once{i}", log)
    assert len(cache.seen) == forward_graph.MAX_GRAPHS
    assert drive(cache, "once0", log)[1] == forward_graph.EAGER


def test_failed_capture_keeps_the_key_eager():
    cache = forward_graph.Cache()
    runs = []
    call = lambda: cache.call("k", (), lambda: runs.append(1) or "eager",
                              lambda: ("eager", None), lambda g: "replay")
    assert call()[1] == forward_graph.EAGER
    assert call()[1] == forward_graph.CAPTURE
    assert [call()[1] for _ in range(3)] == [forward_graph.EAGER] * 3
    assert len(runs) == 4


class FakeGraph:
    def __init__(self, fn):
        self.replay = fn


def test_graphs_replay_counts_and_copies():
    """Graphs.replay on stand-in graphs: the lengths are copied into the
    static input, the stages run in order, the sweep's counters advance by
    the captured launches, and the logL is a copy of the static output."""
    static_bl, out = torch.zeros(3), torch.zeros(())
    order = []
    graphs = (FakeGraph(lambda: order.append("pmatrix")),
              FakeGraph(lambda: order.append("sweep")),
              FakeGraph(lambda: (order.append("root"),
                                 out.copy_(static_bl.sum()))))
    delta = (1, {"fma": 1, "mma": 0}, 1, {"fma": 0, "mma": 0})
    g = forward_graph.Graphs(graphs, static_bl, out, delta, ())
    before = forward_graph._sweep_counts()
    first = g.replay(torch.tensor([1.0, 2.0, 3.0]))
    second = g.replay(torch.tensor([1.0, 1.0, 1.0]))
    after = forward_graph._sweep_counts()
    forward_graph._set_sweep_counts(before)
    assert order == ["pmatrix", "sweep", "root"] * 2
    assert first.item() == 6.0 and second.item() == 3.0
    assert first.data_ptr() != out.data_ptr()
    assert after[0] - before[0] == 2 and after[2] - before[2] == 2
    assert after[1]["fma"] - before[1]["fma"] == 2
    assert after[1]["mma"] == before[1]["mma"]


def test_engine_through_a_capture_stand_in(monkeypatch):
    """engine.loglikelihood on the CPU with eligibility forced and capture
    replaced by a stand-in that runs the three stages it is given: each
    call's logL equals the eager path's bit for bit, and the counters go
    eager, capture, replay."""
    c = make_case("cpu", per_rate=True, bl_scale=20.0)

    class Stages:
        def __init__(self, stages):
            self.stages = stages

        def replay(self, bl):
            pm, sweep, root = self.stages
            pmatrix = pm(bl)
            return root(sweep(pmatrix), pmatrix)

    monkeypatch.setattr(forward_graph, "eligible", lambda *a: True)
    monkeypatch.setattr(forward_graph, "capture",
                        lambda stages, eager, device, bl:
                        (eager(), Stages(stages)))
    before = counts()
    for f in (1.0, 0.8, 1.3, 0.9):
        bl = c.bl * f
        assert torch.equal(engine.loglikelihood(*c.args(bl)),
                           eager_logl(c, bl))
    assert advanced(before) == {forward_graph.EAGER: 1,
                                forward_graph.CAPTURE: 1,
                                forward_graph.REPLAY: 2}


def test_suppressed_spans_record_nothing():
    """Captures run inside spans.suppressed(): no span is recorded there,
    even inside recording(), and spans record again after it."""
    spans.clear()
    with spans.recording():
        with spans.suppressed():
            with spans.span("pmatrix"):
                pass
        with spans.span("root"):
            pass
    assert [r.name for r in spans.records()] == ["libpll2.root"]
    spans.clear()


def share_reader():
    path = pathlib.Path(__file__).resolve().parent.parent / "pllbench" / \
        "metrics" / "forward_graph_share.eval.py"
    spec = importlib.util.spec_from_file_location("forward_graph_share",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_forward_graph_share_reader(monkeypatch):
    """The benchmark's forward_graph_share.eval: replays over all calls in
    %, None without the counters (a program from before them) or with no
    call counted."""
    read = share_reader()
    fn = engine.loglikelihood
    for name, n in (("graph_replays", 98), ("graph_captures", 1),
                    ("eager_calls", 1)):
        monkeypatch.setattr(fn, name, n)
    assert read(None) == pytest.approx(98.0)
    monkeypatch.setattr(fn, "graph_replays", 0)
    monkeypatch.setattr(fn, "graph_captures", 0)
    monkeypatch.setattr(fn, "eager_calls", 0)
    assert read(None) is None
    monkeypatch.delattr(fn, "graph_replays")
    assert read(None) is None


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


CARD_CASES = {
    "dna": dict(states=4),
    "dna_per_rate": dict(states=4, per_rate=True, bl_scale=30.0),
    "lg": dict(states=20, lg=True),
    "lg_per_rate": dict(states=20, lg=True, per_rate=True, bl_scale=30.0),
    "generic5": dict(states=5),
    "generic5_per_rate": dict(states=5, per_rate=True, bl_scale=30.0),
    "dna_mma": dict(states=4, sweep_mode="mma", sites=2048),
    "dna_bf16": dict(states=4, dtype=torch.bfloat16),
    "dna_pinv": dict(states=4, pinv=0.25),
    "dna_asc_lewis": dict(states=4, asc=AB_LEWIS),
}
FACTORS = (1.0, 0.8, 1.25, 0.9, 1.1, 1.0)


def calls(c: Case):
    """The graph path's logL of each factor's lengths (eager, capture,
    then replays), no warning raised."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return [engine.loglikelihood(*c.args(c.bl * f)) for f in FACTORS]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_replay_equals_eager(cuda_device, name):
    c = make_case(cuda_device, **CARD_CASES[name])
    want = [eager_logl(c, c.bl * f) for f in FACTORS]
    before = counts()
    got = calls(c)
    assert advanced(before) == {forward_graph.EAGER: 1,
                                forward_graph.CAPTURE: 1,
                                forward_graph.REPLAY: len(FACTORS) - 2}
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g)) and torch.equal(g, w), (g, w)
    assert not torch.equal(got[1], got[2])


@pytest.mark.cuda
def test_kept_result_unchanged(cuda_device):
    c = make_case(cuda_device)
    calls(c)
    kept = engine.loglikelihood(*c.args(c.bl * 0.7))
    value = kept.clone()
    other = engine.loglikelihood(*c.args(c.bl * 1.4))
    torch.cuda.synchronize()
    assert torch.equal(kept, value) and not torch.equal(kept, other)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dna", "generic5", "dna_mma", "dna_bf16"])
def test_replay_advances_sweep_launches(cuda_device, name):
    c = make_case(cuda_device, **CARD_CASES[name])
    calls(c)
    before = forward_graph._sweep_counts()
    engine.loglikelihood(*c.args())
    engine.loglikelihood(*c.args(c.bl * 1.2))
    after = forward_graph._sweep_counts()
    mode = engine.kernel_choice(c.program, c.cfg, cuda_device)[1]
    assert after[0] - before[0] == 2
    assert after[1][mode] - before[1][mode] == 2
    assert after[2] - before[2] == (2 if name == "generic5" else 0)
    assert after[3][mode] - before[3][mode] == (2 if name == "dna_bf16"
                                                else 0)


@pytest.mark.cuda
def test_model_changed_in_place(cuda_device):
    c = make_case(cuda_device)
    calls(c)
    old = engine.loglikelihood(*c.args())
    with torch.no_grad():
        c.model.eigenvals.mul_(1.3)
    before = counts()
    new = engine.loglikelihood(*c.args())
    assert advanced(before)[forward_graph.REPLAY] == 1
    assert torch.equal(new, eager_logl(c, c.bl))
    assert not torch.equal(new, old)


@pytest.mark.cuda
def test_replay_spans(cuda_device):
    c = make_case(cuda_device)
    calls(c)
    spans.clear()
    with spans.recording():
        engine.loglikelihood(*c.args())
    recs = {r.name: r for r in spans.records()}
    forward = recs["libpll2.forward"]
    for name in ("pmatrix", "sweep", "root"):
        rec = recs["libpll2." + name]
        assert rec.parent == forward.id
        assert rec.stream_ms is not None and rec.stream_ms >= 0.0
    assert forward.stream_ms is not None
    spans.clear()
