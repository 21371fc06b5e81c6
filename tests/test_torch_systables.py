"""Standalone ``system.*`` tables and the query history in the port
(``observability/systables.py``'s ``StandaloneQueryRecorder``, wired
into ``BallistaContext._standalone_collect``) against the JAX package's,
on the CPU at TPC-H SF0.002, after one q1 on each:

- ``system.queries``: the q1 row equals the JAX package's field for
  field, apart from times (``started_at``, ``wall_seconds``), ids
  (``job_id``: ``local-<pid>-<n>``) and the memory peaks, which measure
  each engine's own buffers;
- ``system.latency``: the same columns, and the job's rows name the same
  phases with the same origin and status;
- ``system.query_lanes``: the same lanes;
- the query history (``BALLISTA_QUERY_LOG_DIR``): both write a record
  with the same keys and the same values apart from the same fields,
  and a process that starts afresh reads it back through
  ``system.queries`` as ``origin='history'``;
- every system table has the JAX package's columns on a standalone
  context, and its batches are made on the context's device.
"""

import json
import os

import pytest

from ballista_tpu_torch.observability import systables as port_systables

from torch_warm_path import generate_tpch, pinned_threads, port_ctx, sql

VARIES = {"job_id", "started_at", "wall_seconds", "peak_host_bytes",
          "peak_device_bytes"}


@pytest.fixture(scope="module", autouse=True)
def _pinned():
    with pinned_threads(2):
        yield


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    return generate_tpch(str(tmp_path_factory.mktemp("tpch_systables")))


@pytest.fixture
def history_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BALLISTA_QUERY_LOG_DIR", str(tmp_path))
    yield str(tmp_path)


@pytest.fixture
def both(tpch_dir, history_dir):
    """A port and a JAX context, each after one q1 (with the history log
    on), and each one's q1 job id."""
    from ballista_tpu.client import BallistaContext as ReferenceContext
    from benchmarks.tpch.schema_def import register_tpch as register_ref

    port = port_ctx(tpch_dir)
    port.sql(sql("q1")).to_pydict()
    ref = ReferenceContext.standalone()
    register_ref(ref, tpch_dir, "tbl")
    ref.sql(sql("q1")).collect()
    return (port, port.last_query_ledger()["job_id"],
            ref, ref.last_query_ledger()["job_id"])


def _records(out):
    """Rows of a collect (port dict of arrays or JAX pandas frame) as
    dicts of plain values, NULLs as None."""
    import math

    cols = list(out.keys() if isinstance(out, dict) else out.columns)
    n = len(out[cols[0]]) if cols else 0
    rows = []
    for i in range(n):
        row = {}
        for c in cols:
            v = out[c][i]
            v = v.item() if hasattr(v, "item") else v
            if isinstance(v, float) and math.isnan(v):
                v = None
            row[c] = v
        rows.append(row)
    return rows


def _job_rows(ctx, table, job_id, port):
    ctx._plan_cache.clear()
    df = ctx.sql(f"select * from {table}")
    out = df.to_pydict() if port else df.collect()
    return [r for r in _records(out) if r["job_id"] == job_id]


def test_system_queries_row_equals_reference(both):
    port, job, ref, ref_job = both
    [mine] = _job_rows(port, "system.queries", job, True)
    [theirs] = _job_rows(ref, "system.queries", ref_job, False)
    assert set(mine) == set(theirs)
    assert {k: v for k, v in mine.items() if k not in VARIES} == \
        {k: v for k, v in theirs.items() if k not in VARIES}
    assert mine["status"] == "completed" and mine["output_rows"] == 4
    assert mine["origin"] == "standalone"
    assert mine["job_id"].startswith("local-") and mine["wall_seconds"] > 0


def test_system_latency_rows_equal_reference(both):
    port, job, ref, ref_job = both
    mine = _job_rows(port, "system.latency", job, True)
    theirs = _job_rows(ref, "system.latency", ref_job, False)
    assert set(mine[0]) == set(theirs[0])

    def shape(rows):
        return sorted((r["phase"], r["origin"], r["status"]) for r in rows)

    assert shape(mine) == shape(theirs)
    assert all(r["seconds"] >= 0.0 for r in mine)


def test_system_query_lanes_equal_reference(both):
    port, job, ref, ref_job = both
    mine = _job_rows(port, "system.query_lanes", job, True)
    theirs = _job_rows(ref, "system.query_lanes", ref_job, False)
    assert sorted(r["lane"] for r in mine) == \
        sorted(r["lane"] for r in theirs)
    assert {r["plan_digest"] for r in mine} == \
        {r["plan_digest"] for r in theirs}


def test_query_history_equals_reference_and_survives(both, history_dir):
    port, job, ref, ref_job = both
    with open(os.path.join(history_dir, "query_history.jsonl")) as fh:
        recs = {r["job_id"]: r for r in map(json.loads, fh)}
    mine, theirs = recs[job], recs[ref_job]
    assert set(mine) == set(theirs)
    assert {k: v for k, v in mine.items() if k not in VARIES | {"lanes"}} \
        == {k: v for k, v in theirs.items() if k not in VARIES | {"lanes"}}
    assert set(mine["lanes"]) == set(theirs["lanes"])
    # a fresh process: the in-memory rings are gone, the log is not
    port_systables._reset_process_state_for_tests()
    [row] = _job_rows(port, "system.queries", job, True)
    assert row["origin"] == "history" and row["output_rows"] == 4


def test_every_system_table_has_the_reference_columns(tpch_dir):
    from ballista_tpu.observability import systables as ref_systables

    assert sorted(port_systables.SYSTEM_SCHEMAS) == \
        sorted(ref_systables.SYSTEM_SCHEMAS)
    ctx = port_ctx(tpch_dir)
    for table, schema in port_systables.SYSTEM_SCHEMAS.items():
        df = ctx.sql(f"select * from {table}")
        assert ctx.table(table).plan.source.device.type == "cpu"
        assert df.schema().names() == \
            ref_systables.SYSTEM_SCHEMAS[table].names(), table
        out = df.to_pydict()
        assert list(out) == list(schema.names()), table
