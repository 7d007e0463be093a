"""The run with the timed path broken underneath: ``correct`` comes out
false for each fault the cell can have.  (The exchange between chips is not
one: the cells run on one card.)"""

import io

import pytest

from portbench import harness
from portbench.tests.toy import toy_root

CELLS = ["chr21rep_se100.wgs", "chr21rep_pe150.wgs"]


def stale(stream):
    """A step that returns its state unchanged: every batch after the first
    yields the first batch's records again."""
    first = None
    for s, (lines, flags) in stream:
        first = first or (lines, flags)
        yield s, first


def half(stream):
    """Half of each batch left out."""
    for s, (lines, flags) in stream:
        yield s, (lines[:len(lines) // 2], flags[:len(flags) // 2])


def altered(stream):
    """An answer altered where it is produced: every 8th mapped record one
    base to the right."""
    for s, (lines, flags) in stream:
        out = list(lines)
        for j in range(0, len(out), 8):
            f = out[j].split("\t")
            if f[3] != "0":
                f[3] = str(int(f[3]) + 1)
                out[j] = "\t".join(f)
        yield s, (out, flags)


def x1_dropped_and_moved(stream):
    """Every record stripped of ``X1``, as the port marks a capped
    enumeration, and every 8th mapped record one base to the right: a fault
    that no record's own tags can excuse."""
    for s, (lines, flags) in altered(stream):
        yield s, ([ln.replace("\tX1:i:", "\tXX:i:") for ln in lines], flags)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [stale, half, altered,
                                   x1_dropped_and_moved])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, cell):
    from hsa_tpu_torch.pipeline import Aligner
    name = "align_pe_stream" if "pe" in cell else "align_stream"
    orig = getattr(Aligner, name)
    monkeypatch.setattr(Aligner, name,
                        lambda self, *a, **k: fault(orig(self, *a, **k)))
    root, _ = toy_root(str(tmp_path), sample=64 if "se" in cell else 160)
    res = harness.run(cell, 2 ** 34 + 9, 2, False, device="cpu", root=root,
                      cache=str(tmp_path / "cache"), out=io.StringIO(),
                      log=io.StringIO())
    assert res["correct"] is False
