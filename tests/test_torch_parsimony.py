"""Parsimony of the port against libpll2_tpu on the CPU: the glibc RNG,
the build operations, the bit count, Fitch (FastParsimony) and Sankoff
(Parsimony) scoring and stepwise addition.  The same numpy-seeded inputs
go through both packages (the cases of tests/test_parsimony.py and
tests/test_stepwise.py, without their C oracle).

Tolerances: none.  Parsimony scores are integers (Fitch) or exact sums of
the score matrix's entries (Sankoff), the packed words and the topologies
are compared bit for bit and split for split."""
import dataclasses

import numpy as np
import pytest
import torch

import libpll2_tpu as pll
from libpll2_tpu import tree as JT
from libpll2_tpu.parsimony import (fastparsimony_stepwise as j_stepwise,
                                   fastparsimony_stepwise_extend as j_extend,
                                   fastparsimony_stepwise_spr_round as j_spr)
from libpll2_tpu.utils import random as jrandom
from libpll2_tpu_torch import MAPS, FastParsimony, Parsimony
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.parsimony import (ParsBuildOp, ParsRecOp,
                                         fastparsimony_stepwise,
                                         fastparsimony_stepwise_extend,
                                         fastparsimony_stepwise_spr_round)
from libpll2_tpu_torch.parsimony.fitch import popcount32
from libpll2_tpu_torch.utils import random as prandom

from .test_parity_tree import random_newick, random_seqs
from .test_parsimony import random_rooted_newick
from .test_stepwise import canonical_splits

AA = "ARNDCQEGHILKMFPSTWYV"


# --------------------------------------------------------------------------
# host pieces: RNG, build ops, bit count
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 42, 12345])
def test_glibc_random_equal(seed):
    a, b = jrandom.GlibcRandom(seed), prandom.GlibcRandom(seed)
    got = [b.next() for _ in range(1000)]
    assert got == [a.next() for _ in range(1000)]
    if seed == 1:
        assert got[:5] == [1804289383, 846930886, 1681692777, 1714636915,
                           1957747793]
    for n in (1, 5, 37, 256):
        np.testing.assert_array_equal(prandom.create_shuffled(n, seed),
                                      jrandom.create_shuffled(n, seed))
    np.testing.assert_array_equal(prandom.create_shuffled(9, 0),
                                  np.arange(9))


def _op_tuples(ops):
    return [(o.parent_score_index, o.child1_score_index,
             o.child2_score_index) for o in ops]


@pytest.mark.parametrize("n,seed", [(4, 0), (11, 3), (40, 8)])
def test_create_pars_buildops_equal(n, seed):
    newick = random_newick(n, np.random.default_rng(seed))
    jt, pt = JT.parse_newick_string(newick), T.parse_newick_string(newick)
    # a traversal rooted at each inner half-node (the two lists hold the
    # same nodes in the same order)
    for jh, ph in zip(JT.traverse(jt.vroot), T.traverse(pt.vroot)):
        if ph.next is None:
            continue
        got = T.create_pars_buildops(T.traverse(ph))
        assert all(isinstance(o, ParsBuildOp) for o in got)
        assert _op_tuples(got) == _op_tuples(
            JT.create_pars_buildops(JT.traverse(jh)))


def test_popcount32():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        np.array([0, -1, -2 ** 31, 2 ** 31 - 1, 1, 0x55555555,
                  -0x55555556], dtype=np.int64),
        rng.integers(-2 ** 31, 2 ** 31, 2000)]).astype(np.int32)
    got = popcount32(torch.as_tensor(words))
    want = [bin(int(w) & 0xFFFFFFFF).count("1") for w in words]
    assert got.dtype == torch.int64
    assert got.tolist() == want
    assert got[:3].tolist() == [0, 32, 1]


# --------------------------------------------------------------------------
# Fitch (the four cases of tests/test_parsimony.py:202-248)
# --------------------------------------------------------------------------

def fitch_inputs(case):
    """(newick, sequences, weights or None, states, map name), drawn as the
    JAX test of the same case draws them."""
    if case == "dna":
        rng = np.random.default_rng(7)
        return random_newick(12, rng), random_seqs(12, 61, rng), None, 4, \
            "nt"
    if case == "weights":
        rng = np.random.default_rng(13)
        newick, seqs = random_newick(9, rng), random_seqs(9, 40, rng)
        return newick, seqs, rng.integers(1, 5, 40), 4, "nt"
    if case == "ambiguities":
        rng = np.random.default_rng(17)
        newick, seqs = random_newick(10, rng), random_seqs(10, 45, rng)
        for i in range(10):
            s = list(seqs[i])
            for j in rng.choice(45, 8, replace=False):
                s[j] = "RYSWKMN-"[rng.integers(0, 8)]
            seqs[i] = "".join(s)
        return newick, seqs, None, 4, "nt"
    rng = np.random.default_rng(19)
    newick = random_newick(7, rng)
    seqs = ["".join(AA[b] for b in rng.integers(0, 20, 33))
            for _ in range(7)]
    return newick, seqs, None, 20, "aa"


def _all_direction_ops(tree, traverse, buildops):
    """Build ops of every directional vector: a post-order traversal
    rooted at each inner half-node."""
    ops = []
    for h in traverse(tree.vroot):
        if h.next is not None:
            for start in (h, h.next, h.next.next):
                ops.extend(buildops(traverse(start)))
    return ops


@pytest.mark.parametrize("case", ["dna", "weights", "ambiguities",
                                  "protein"])
def test_fast_parsimony_equal(case):
    newick, seqs, weights, states, map_name = fitch_inputs(case)
    jt, pt = JT.parse_newick_string(newick), T.parse_newick_string(newick)
    tips, sites = jt.tip_count, len(seqs[0])
    part = pll.Partition(tips, jt.inner_count, states, sites, 1,
                         2 * tips - 3, 1, jt.inner_count)
    for i, s in enumerate(seqs):
        part.set_tip_states(i, pll.MAPS[map_name], s)
    if weights is not None:
        part.set_pattern_weights(weights)
    jfp = pll.FastParsimony(part)
    tipchars = np.stack([MAPS[map_name][np.frombuffer(s.encode(), np.uint8)]
                         for s in seqs]).astype(np.uint64)
    pfp = FastParsimony(tipchars=tipchars,
                        weights=np.ones(sites) if weights is None
                        else weights, tips=tips, states=states, sites=sites,
                        device="cpu")

    def same_words():
        assert pfp.packed.dtype == torch.int32
        np.testing.assert_array_equal(pfp.packed.numpy().view(np.uint32),
                                      np.asarray(jfp.packed))
        np.testing.assert_array_equal(pfp.node_cost.numpy(),
                                      np.asarray(jfp.node_cost))

    assert pfp.const_cost == jfp.const_cost
    assert pfp.informative_count == jfp.informative_count
    np.testing.assert_array_equal(pfp.informative, jfp.informative)
    assert pfp.packedvector_count == jfp.packedvector_count
    same_words()

    # the root edge first, as the JAX test scores it
    jops = JT.create_pars_buildops(JT.traverse(jt.vroot))
    pops = T.create_pars_buildops(T.traverse(pt.vroot))
    jfp.update_vectors(jops)
    pfp.update_vectors(pops)
    same_words()
    edge = (pt.vroot.node_index, pt.vroot.back.node_index)
    assert pfp.edge_score(*edge) == jfp.edge_score(*edge)
    assert pfp.root_score(pt.vroot.node_index) == \
        jfp.root_score(pt.vroot.node_index)

    # then every direction of every edge
    jfp.update_vectors(_all_direction_ops(jt, JT.traverse,
                                          JT.create_pars_buildops))
    pfp.update_vectors(_all_direction_ops(pt, T.traverse,
                                          T.create_pars_buildops))
    same_words()
    halves = [h for h in T.traverse(pt.vroot)]
    pairs = np.array([[h.node_index, h.back.node_index] for h in halves],
                     dtype=np.int32)
    got = pfp.edge_scores_batch(pairs)
    np.testing.assert_array_equal(got, jfp.edge_scores_batch(pairs))
    assert got.tolist() == [jfp.edge_score(*p) for p in pairs.tolist()]
    # with every direction computed, each edge scores the whole tree
    assert len(set(got.tolist())) == 1
    for sub in (0, tips - 1, pt.vroot.node_index):
        np.testing.assert_array_equal(pfp.placement_scores(pairs, sub),
                                      jfp.placement_scores(pairs, sub))
    for h in halves:
        assert pfp.root_score(h.node_index) == jfp.root_score(h.node_index)


# --------------------------------------------------------------------------
# Sankoff (the cases of tests/test_parsimony.py:76-126)
# --------------------------------------------------------------------------

def sankoff_inputs(case):
    """(newick, sequences, score matrix, states, map name)."""
    unit = 1.0 - np.eye(4)
    if case == "unit":
        rng = np.random.default_rng(11)
        return random_rooted_newick(8, rng), random_seqs(8, 37, rng), unit, \
            4, "nt"
    if case == "weighted":
        rng = np.random.default_rng(23)
        sm = np.array([[0, 2.5, 1.0, 2.5], [2.5, 0, 2.5, 1.0],
                       [1.0, 2.5, 0, 2.5], [2.5, 1.0, 2.5, 0]], dtype=float)
        return random_rooted_newick(10, rng), random_seqs(10, 53, rng), sm, \
            4, "nt"
    if case == "ambiguities":
        rng = np.random.default_rng(5)
        newick, seqs = random_rooted_newick(6, rng), random_seqs(6, 31, rng)
        chars = "RYSWKMBDHVN-"
        for i in range(6):
            s = list(seqs[i])
            for j in rng.choice(31, 6, replace=False):
                s[j] = chars[rng.integers(0, len(chars))]
            seqs[i] = "".join(s)
        return newick, seqs, unit, 4, "nt"
    rng = np.random.default_rng(31)
    newick = random_rooted_newick(5, rng)
    seqs = ["".join(AA[b] for b in rng.integers(0, 20, 19))
            for _ in range(5)]
    return newick, seqs, 1.0 - np.eye(20), 20, "aa"


@pytest.mark.parametrize("case", ["unit", "weighted", "ambiguities",
                                  "protein"])
def test_sankoff_equal(case):
    newick, seqs, sm, states, map_name = sankoff_inputs(case)
    # the port has no rooted-tree module yet: the JAX package's rtree
    # gives both sides the same operations
    rt = JT.parse_rtree_string(newick)
    tips, sites = rt.tip_count, len(seqs[0])
    jbuild = JT.rtree_create_pars_buildops(JT.rtree_traverse(rt.root))
    jrec = JT.rtree_create_pars_recops(JT.rtree_traverse(
        rt.root, order=pll.constants.TRAVERSE_PREORDER))
    pbuild = [ParsBuildOp(**dataclasses.asdict(o)) for o in jbuild]
    prec = [ParsRecOp(**dataclasses.asdict(o)) for o in jrec]

    jp = pll.Parsimony(tips, states, sites, sm, score_buffers=tips - 1,
                       ancestral_buffers=tips - 1)
    pp = Parsimony(tips, states, sites, sm, score_buffers=tips - 1,
                   ancestral_buffers=tips - 1, device="cpu")
    for i, s in enumerate(seqs):
        jp.set_tip_states(i, pll.MAPS[map_name], s)
        pp.set_tip_states(i, MAPS[map_name], s)
    np.testing.assert_array_equal(pp.sbuffer.numpy(), np.asarray(jp.sbuffer))
    assert pp.build(pbuild) == jp.build(jbuild)
    np.testing.assert_array_equal(pp.sbuffer.numpy(), np.asarray(jp.sbuffer))
    for op in pbuild:
        assert pp.score(op.parent_score_index) == \
            jp.score(op.parent_score_index)
    jp.reconstruct(pll.MAPS[map_name], jrec)
    pp.reconstruct(MAPS[map_name], prec)
    for op in prec:
        idx = op.node_ancestral_index
        assert pp.get_ancestral(idx) == jp.get_ancestral(idx)
        assert len(pp.get_ancestral(idx)) == sites
    with pytest.raises(ValueError):
        pp.set_tip_states(0, MAPS[map_name], "@" * sites)


# --------------------------------------------------------------------------
# stepwise addition (the cases of tests/test_stepwise.py)
# --------------------------------------------------------------------------

def both_pars(seqs, n_tips, sites):
    """The JAX FastParsimony through its Partition, and the port's from the
    same characters."""
    part = pll.Partition(n_tips, n_tips - 2, 4, sites, 1, 2 * n_tips - 3, 1,
                         n_tips - 2)
    for i, s in enumerate(seqs[:n_tips]):
        part.set_tip_states(i, pll.MAP_NT, s)
    tipchars = np.stack([MAPS["nt"][np.frombuffer(s.encode(), np.uint8)]
                         for s in seqs[:n_tips]]).astype(np.uint64)
    return pll.FastParsimony(part), FastParsimony(
        tipchars=tipchars, weights=np.ones(sites), tips=n_tips, states=4,
        sites=sites, device="cpu")


@pytest.mark.parametrize("n_tips,seed", [(8, 42), (13, 7), (20, 12345)])
def test_stepwise_equal(n_tips, seed):
    seqs = random_seqs(n_tips, 50, np.random.default_rng(seed))
    labels = [f"t{i}" for i in range(n_tips)]
    jfp, pfp = both_pars(seqs, n_tips, 50)
    jtree, jcost = j_stepwise([jfp], labels, seed)
    ptree, pcost = fastparsimony_stepwise([pfp], labels, seed)
    assert pcost == jcost
    assert canonical_splits(ptree) == canonical_splits(jtree)
    assert T.check_integrity(ptree)


@pytest.mark.parametrize("seed,spr_seed", [(42, 17), (5, 99)])
def test_stepwise_spr_round_equal(seed, spr_seed):
    n_tips, sites = 15, 60
    seqs = random_seqs(n_tips, sites, np.random.default_rng(seed))
    labels = [f"t{i}" for i in range(n_tips)]
    jfp, pfp = both_pars(seqs, n_tips, sites)
    jtree, jcost = j_stepwise([jfp], labels, seed)
    ptree, pcost = fastparsimony_stepwise([pfp], labels, seed)
    assert pcost == jcost
    constraint = np.zeros(2 * n_tips, dtype=np.int64)
    jspr = j_spr(jtree, [jfp], spr_seed, clv_index_map=constraint)
    pspr = fastparsimony_stepwise_spr_round(ptree, [pfp], spr_seed,
                                            clv_index_map=constraint)
    assert pspr == jspr
    assert canonical_splits(ptree) == canonical_splits(jtree)


def test_stepwise_extend_equal():
    n_old, n_new, sites = 8, 12, 40
    seqs = random_seqs(n_new, sites, np.random.default_rng(3))
    labels = [f"t{i}" for i in range(n_new)]
    jold, pold = both_pars(seqs, n_old, sites)
    jnew, pnew = both_pars(seqs, n_new, sites)
    jtree, _ = j_stepwise([jold], labels[:n_old], 11)
    ptree, _ = fastparsimony_stepwise([pold], labels[:n_old], 11)
    jcost = j_extend(jtree, [jnew], labels[n_old:], 23)
    pcost = fastparsimony_stepwise_extend(ptree, [pnew], labels[n_old:], 23)
    assert pcost == jcost
    assert canonical_splits(ptree) == canonical_splits(jtree)
    assert ptree.tip_count == n_new and ptree.inner_count == n_new - 2
    assert T.check_integrity(ptree)
    # the JAX test's own check: a fresh Fitch pass over the final topology
    _, fresh = both_pars(seqs, n_new, sites)
    fresh.update_vectors(T.create_pars_buildops(T.traverse(ptree.vroot)))
    assert pcost == fresh.edge_score(ptree.vroot.node_index,
                                     ptree.vroot.back.node_index)
