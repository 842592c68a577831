"""The port's demos against libpll2_tpu's examples/, on the CPU: the io,
tree and parsimony demos (newick_fasta_unrooted, newick_phylip_unrooted,
load_utree, newick_export, parsimony_demo, stepwise_demo), each with its
default input and load_utree / newick_export also with a newick file as
their positional argument; then every one of the 18 demos run
in-process without `--device`, where it must raise on a machine with no
card.  Comparison and masks: test_torch_examples_partition.py."""
import importlib

import pytest
import torch

from .test_torch_examples_partition import PARTITION_DEMOS, compare, run_pair

IO_DEMOS = ["newick_fasta_unrooted", "newick_phylip_unrooted", "load_utree",
            "newick_export", "parsimony_demo", "stepwise_demo"]
SEARCH_DEMOS = ["optimize_demo", "infer_demo", "large_search"]
ROOTED = "(((A:0.1,B:0.2):0.05,(C:0.3,D:0.1):0.2):0.1,(E:0.2,F:0.4):0.3);"


@pytest.mark.parametrize("name", IO_DEMOS)
def test_io_demo_matches_jax(name):
    want, got = run_pair(name)
    assert got.strip()
    compare(name, want, got)


@pytest.mark.parametrize("name", ["load_utree", "newick_export"])
def test_tree_demo_file_argument(name, tmp_path):
    """A rooted six-taxon newick file: unrooted, re-indexed and exported
    from a random inner node by both packages alike."""
    path = tmp_path / "rooted.nwk"
    path.write_text(ROOTED)
    want, got = run_pair(name, (str(path),))
    assert "F" in got
    compare(name, want, got)


@pytest.mark.parametrize("name",
                         PARTITION_DEMOS + IO_DEMOS + SEARCH_DEMOS)
def test_demo_raises_without_a_card(name):
    """With no --device a demo runs on the card; with none it raises and
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    module = importlib.import_module(f"libpll2_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main([])
