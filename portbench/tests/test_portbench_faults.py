"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run (data, reference, ingest, warm-up, window,
comparison) at a tiny size on the CPU, past the harness's look for a
card, with the program's device path on its plain kernels
(HOST_SCAN_MAX_ELEMS = 0).  Faults: an answer altered where the scan
produces it, half of each batch answered with the other half's answers,
acknowledged inserts lost, and metadata altered in result assembly."""

import time

import pytest
import torch

from conftest import tiny_tree

CELLS = ["tweets384-1.6m.high-b1024", "radius.tiny"]


def _answer_altered(monkeypatch, coll):
    from syzgydb_tpu_torch.core.collection import Collection
    orig = Collection._exact_topk_device

    def broken(self, *a, **kw):
        dist, rows, *rest = orig(self, *a, **kw)
        rows = rows.clone()
        rows[0, 0] = (rows[0, 0] + 1) % self.columns.size
        return (dist, rows, *rest)
    monkeypatch.setattr(Collection, "_exact_topk_device", broken)


def _half_batch(monkeypatch, coll):
    from syzgydb_tpu_torch.core.collection import Collection
    for name in ("search_many", "radius_many"):
        orig = getattr(Collection, name)

        def broken(self, args, orig=orig):
            half = orig(self, args[:max(1, len(args) // 2)])
            return (half * 2)[:len(args)]
        monkeypatch.setattr(Collection, name, broken)


def _inserts_lost(monkeypatch, coll):
    for i in range(0, coll.get_document_count(), 5):
        coll.remove_document(i)


def _metadata_altered(monkeypatch, coll):
    from syzgydb_tpu_torch.core.collection import Collection, SearchResult
    orig = Collection._mk_result

    def broken(self, row, d):
        r = orig(self, row, d)
        return SearchResult(r.id, r.metadata.replace(b"i", b"j"), r.distance)
    monkeypatch.setattr(Collection, "_mk_result", broken)


FAULTS = {"answer_altered": _answer_altered, "half_batch": _half_batch,
          "inserts_lost": _inserts_lost,
          "metadata_altered": _metadata_altered}


def _run(tmp_path, spec, cell_name, monkeypatch, fault=None):
    from syzgydb_tpu_torch.core import collection

    from portbench import harness
    monkeypatch.setattr(collection, "HOST_SCAN_MAX_ELEMS", 0)
    tspec, root, bench = tiny_tree(tmp_path, spec)
    cell = harness.Cell(tspec, cell_name, root=root, bench=bench)
    hook = None if fault is None else \
        (lambda coll: FAULTS[fault](monkeypatch, coll))
    return harness.run_cell(cell, 2**31 + 11, 1.0, False,
                            torch.device("cpu"), time.perf_counter(),
                            faults=hook)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, spec, cell, monkeypatch):
    r = _run(tmp_path, spec, cell, monkeypatch)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"qps", "p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tmp_path, spec, cell, fault, monkeypatch):
    r = _run(tmp_path, spec, cell, monkeypatch, fault)
    assert not r["correct"], r["checks"]
