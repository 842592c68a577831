"""The port's host-only tree moves and topology comparison against
libpll2_tpu: the same moves on the same random trees give the same
newick, and RF distances and split sets are equal."""
import numpy as np
import pytest

from libpll2_tpu import tree as jtree
from libpll2_tpu.tree import compare as jcompare
from libpll2_tpu.tree import moves as jmoves
from libpll2_tpu_torch import tree as T
from libpll2_tpu_torch.tree import compare, moves
from libpll2_tpu_torch.tree.generate import random_newick


def half_nodes(tree):
    out = []
    for node in tree.nodes:
        out.extend([node] if node.next is None else list(node.roundabout()))
    return out


def pair(n, seed):
    newick = random_newick(n, np.random.default_rng(seed))
    return T.parse_newick_string(newick), jtree.parse_newick_string(newick)


def newicks(pt, jt):
    return (T.export_newick(pt.vroot, precision=None),
            jtree.export_newick(jt.vroot, precision=None))


@pytest.mark.parametrize("n,seed", [(8, 0), (16, 1), (30, 2)])
def test_spr_and_rollback_equal(n, seed):
    pt, jt = pair(n, seed)
    ph, jh = half_nodes(pt), half_nodes(jt)
    rng = np.random.default_rng(seed + 100)
    done = 0
    for _ in range(40):
        i, k = (int(v) for v in rng.integers(0, len(ph), 2))
        p, r = ph[i], ph[k]
        if p.next is None or moves.subtree_contains(p.back, r):
            continue
        try:
            got = moves.spr(p, r)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err)):
                jmoves.spr(jh[i], jh[k])
            continue
        want = jmoves.spr(jh[i], jh[k])
        assert got[1:] == want[1:]           # changed lengths and pmatrices
        a, b = newicks(pt, jt)
        assert a == b
        if done % 2:
            assert moves.rollback(got[0]) == jmoves.rollback(want[0])
            a, b = newicks(pt, jt)
            assert a == b
        done += 1
    assert done >= 5
    assert T.check_integrity(pt)


@pytest.mark.parametrize("move_type", [moves.NNI_LEFT, moves.NNI_RIGHT])
def test_nni_and_prune_equal(move_type):
    pt, jt = pair(12, 3)
    ph, jh = half_nodes(pt), half_nodes(jt)
    inner = [i for i, h in enumerate(ph)
             if h.next is not None and h.back.next is not None]
    for i in inner[:6]:
        rb = moves.nni(ph[i], move_type)
        jmoves.nni(jh[i], move_type)
        a, b = newicks(pt, jt)
        assert a == b
        moves.rollback(rb)
        jmoves.rollback(jmoves.Rollback(jmoves.MOVE_NNI, p=jh[i],
                                        nni_type=move_type))
        a, b = newicks(pt, jt)
        assert a == b
    with pytest.raises(ValueError, match="terminal"):
        moves.nni(pt.nodes[0], move_type)
    i = inner[0]
    kept = moves.prune_subtree(ph[i])
    jkept = jmoves.prune_subtree(jh[i])
    assert (kept.node_index, kept.length) == (jkept.node_index, jkept.length)


@pytest.mark.parametrize("n,seed", [(6, 0), (20, 4), (64, 5)])
def test_rf_and_splits_equal(n, seed):
    pa, ja = pair(n, seed)
    pb, jb = pair(n, seed + 1)
    assert compare.splits(pa) == jcompare.splits(ja)
    assert len(compare.splits(pa)) == n - 3
    assert compare.rf_distance(pa, pb) == jcompare.rf_distance(ja, jb)
    assert compare.rf_distance_normalized(pa, pb) == \
        jcompare.rf_distance_normalized(ja, jb)
    assert compare.rf_distance(pa, pa) == 0


def test_rf_rejects_other_labels():
    pa, _ = pair(8, 0)
    pb = T.parse_newick_string(random_newick(9, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="label"):
        compare.rf_distance(pa, pb)
