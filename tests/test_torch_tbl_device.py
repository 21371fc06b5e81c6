"""The parse of ``.tbl`` and CSV text on the card (``ballista_tpu_torch/
kernels/tbl_parse.py``, ``csrc/tbl_parse.cu``, the card's path of
``io/text.py``).

On the CPU the plain torch twin of the kernels is held, bit for bit, to
the host scanner (``io/native.py::scan_file``, ``native/tblscan.cpp``):
row count, every column, validity masks, dictionary values and codes; on
generator files at SF0.01 with every projection that q1, q3, q5, q6, q10
and q12 make, and on hand-written files of the edge cases. The card's
scan path itself (staging, dictionaries, batches) runs here on the twin
and is held to the host path's batches; the path choice, the dictionary
step's exact resolution of shared hashes and the counters are tested
directly. The ``test_cuda_*`` tests need a card and skip here; they run
through ``python3 -m ballista_tpu_torch.testing.card_checks``."""

import os

import numpy as np
import pytest
import torch

from ballista_tpu_torch import ingest
from ballista_tpu_torch.datatypes import (Boolean, Date32, Decimal, Float64,
                                          Int32, Int64, Utf8, schema)
from ballista_tpu_torch.errors import IoError
from ballista_tpu_torch.io import CsvSource, TblSource, native, text
from ballista_tpu_torch.io.native import _KIND_CODES
from ballista_tpu_torch.kernels import tbl_parse
from ballista_tpu_torch.testing.tpch_schema import TPCH_SCHEMAS

from torch_warm_path import pinned_threads, reset_port_caches

ROOT = os.path.join(os.path.dirname(__file__), "..")
QUERIES = ["q1", "q3", "q5", "q6", "q10", "q12"]
TABLES = ["lineitem", "orders", "customer", "supplier", "nation", "region"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _pinned_threads():
    """Two torch, ingest and scanner threads for this file's queries
    (``torch_warm_path.pinned_threads``)."""
    with pinned_threads():
        yield


def twin_scan(path, sch, names, delimiter="|", header=False, device=CPU,
              rows_allocated=lambda n: n):
    """The card path's parse of ``path``: staged by ``stage_text``, parsed
    by ``tbl_parse.parse`` (the twin on the CPU, the kernels on a card)."""
    data, size, begin = text.stage_text(path, device, header)
    return tbl_parse.parse(
        data, size, begin, ord(delimiter),
        [_KIND_CODES[f.dtype.kind] for f in sch.fields],
        [f.dtype.scale for f in sch.fields],
        [sch.index_of(m) for m in names], rows_allocated, label=path)


def assert_same_as_host(parsed, path, sch, names, delimiter="|",
                        header=False, label=""):
    n, arrays, dicts, valids = native.scan_file(path, sch, names, delimiter,
                                                header)
    assert parsed.rows == n, label
    for j, m in enumerate(names):
        got = parsed.values[j][:n].cpu().numpy()
        want = arrays[m]
        assert got.shape == want.shape and np.array_equal(got, want), \
            (label, m)
        va = parsed.validity[j]
        assert (va is None) == (m not in valids), (label, m)
        if va is not None:
            assert np.array_equal(va[:n].cpu().numpy(), valids[m]), (label, m)
        sv = parsed.dictionaries[j]
        if sch.field(m).dtype.kind == "utf8":
            vals = sv.strings()
            assert vals.dtype == object and list(vals) == list(dicts[m]), \
                (label, m)
        else:
            assert sv is None


# -- the generator's files at SF0.01, the six queries' projections ---------


@pytest.fixture(scope="module")
def sf001(tmp_path_factory):
    """(data dir, {table: [projections]}): qbench's generator at SF0.01,
    and every projection the six queries scan, as the port plans them."""
    from qbench.data.generate import ensure_data
    from ballista_tpu_torch.client import BallistaContext

    root = str(tmp_path_factory.mktemp("sf001"))
    ensure_data(root, 0.01, 7, TABLES)
    seen = {}
    real = text.DelimitedSource.scan

    def recording(self, partition, projection=None):
        names = tuple(projection if projection is not None
                      else self._schema.names())
        seen.setdefault(os.path.basename(self._path)[:-4], set()).add(names)
        return real(self, partition, projection)

    text.DelimitedSource.scan = recording
    try:
        reset_port_caches()
        ctx = BallistaContext.standalone(device="cpu")
        for t in TABLES:
            ctx.register_source(t, TblSource(os.path.join(root, f"{t}.tbl"),
                                             TPCH_SCHEMAS[t], device="cpu"))
        for q in QUERIES:
            with open(os.path.join(ROOT, "qbench", "queries",
                                   f"{q}.sql")) as f:
                ctx.sql(f.read()).to_pydict()
    finally:
        text.DelimitedSource.scan = real
    return root, {t: sorted(v) for t, v in seen.items()}


@pytest.mark.parametrize("table", TABLES)
def test_twin_equals_host_scanner_on_query_projections(sf001, table):
    root, projections = sf001
    assert projections.get(table), f"no query scanned {table}"
    path = os.path.join(root, f"{table}.tbl")
    sch = TPCH_SCHEMAS[table]
    for names in projections[table] + [tuple(sch.names())]:
        parsed = twin_scan(path, sch, list(names))
        assert_same_as_host(parsed, path, sch, list(names),
                            label=f"{table} {names}")
        assert parsed.hash_collisions == 0


def test_query_projections_cover_the_six_queries(sf001):
    _, projections = sf001
    assert set(projections) == set(TABLES)
    assert ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate") in {
                tuple(sorted(p, key=TPCH_SCHEMAS["lineitem"].index_of))
                for p in projections["lineitem"]}


# -- hand-written edge files ---------------------------------------------------

EDGE_SCHEMA = schema(("i", Int64), ("d", Decimal(2)), ("t", Date32),
                     ("b", Boolean), ("s", Utf8), ("h", Int32))

EDGE_CASES = {
    # empty numeric fields are NULL; an empty utf8 field is ""
    "nulls": (EDGE_SCHEMA, "|", False,
              "1|1.00|1992-01-01|t|a|1|\n"
              "||||||\n"
              "3|||f||3|\n"
              "|2.50|1995-06-17||x||\n"),
    "decimals": (schema(("a", Decimal(2)), ("b", Decimal(0)),
                        ("c", Decimal(4))), "|", False,
                 "+1.5|+1.5|+1.5|\n-2.25|-2.25|-2.25|\n3|3|3|\n"
                 "4.1|4.1|4.1|\n5.125|5.5|5.12345|\n6.124|6.4|6.12344|\n"
                 "7.999|7.9|7.99995|\n-0.005|-0.5|-0.00005|\n"
                 "9.12x|9.x|9.1234x|\n.5|.5|.5|\n-.5|-.5|-.5|\n+|-|+|\n"
                 "12.|12.|12.|\n0.995|0.49|0.99999|\n"
                 "922337203685477.58|9223372036854775807|1.0|\n"),
    "int32_casts": (schema(("a", Int32), ("b", Int64)), "|", False,
                    "2147483648|2147483648|\n-2147483649|-2147483649|\n"
                    "4294967296|4294967296|\n+7|+7|\n-0|-0|\n-|+|\n"
                    "99999999999|-9223372036854775808|\n"),
    "structure": (schema(("a", Int64), ("b", Utf8), ("c", Int64)), "|",
                  False,
                  "\n\n1|x|10|\n\n2|y|20\n3|z|\n4\n5|w|50|extra|more|\n"
                  "\n6|v|60"),
    "csv_header": (schema(("a", Int64), ("b", Utf8), ("c", Decimal(2))),
                   ",", True,
                   "a,b,c\n1,alpha,1.25\n2,beta,-3.5\n\n3,,\n"),
    "header_only": (schema(("a", Int64), ("b", Utf8)), ",", True,
                    "a,b"),
    "one_value": (schema(("k", Int64), ("s", Utf8)), "|", False,
                  "".join(f"{i}|same|\n" for i in range(300))),
    "non_ascii": (schema(("k", Int64), ("s", Utf8), ("r", Utf8)), "|", False,
                  "1|é|日本|\n2|ß|\n3|日本|é|\n4|e|ÿ|\n5||z|\n6|é|é\n"),
    "booleans_dates": (schema(("b", Boolean), ("t", Date32)), "|", False,
                       "true|1992-01-01|\nF|1970-01-01|\n1|2038-12-31|\n"
                       "0|1600-02-29|\nT|0001-01-01|\nfalse|1998-12-01x|\n"
                       "f|19x2-0a-01|\n"),
    "only_newlines": (schema(("a", Int64),), "|", False, "\n\n\n"),
    "empty": (schema(("a", Int64), ("b", Utf8)), "|", False, ""),
}


def _many_distinct(tmp_path):
    rng = np.random.default_rng(3)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    rows = []
    for i in range(4000):
        n = int(rng.integers(0, 30))
        word = "".join(rng.choice(letters, n))
        rows.append(f"{i}|{word}|{int(rng.integers(0, 5))}|\n")
    path = tmp_path / "many.tbl"
    path.write_text("".join(rows))
    return str(path), schema(("k", Int64), ("s", Utf8), ("g", Int64))


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_twin_equals_host_scanner_on_edge_files(tmp_path, case):
    sch, delim, header, body = EDGE_CASES[case]
    path = str(tmp_path / f"{case}.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(body)
    names = sch.names()
    for subset in (names, names[::-1][:max(1, len(names) // 2)]):
        parsed = twin_scan(path, sch, list(subset), delim, header)
        assert_same_as_host(parsed, path, sch, list(subset), delim, header,
                            label=case)


def test_twin_equals_host_scanner_on_many_distinct_values(tmp_path):
    path, sch = _many_distinct(tmp_path)
    parsed = twin_scan(path, sch, ["s", "k"])
    assert_same_as_host(parsed, path, sch, ["s", "k"])
    assert len(parsed.dictionaries[0]) > 3000


def test_twin_decodes_bytes_that_are_not_utf8_as_the_host_does(tmp_path):
    path = tmp_path / "bad_utf8.tbl"
    path.write_bytes(b"1|a\xff|\n2|\xc3|\n3|a\xff|\n4|b|\n")
    sch = schema(("k", Int64), ("s", Utf8))
    parsed = twin_scan(str(path), sch, ["s"])
    assert_same_as_host(parsed, str(path), sch, ["s"])


def test_padding_rows_are_zero_and_not_valid(tmp_path):
    path = tmp_path / "pad.tbl"
    path.write_text("1|x|\n|y|\n3|z|\n")
    sch = schema(("a", Int64), ("s", Utf8))
    parsed = twin_scan(str(path), sch, ["a", "s"],
                       rows_allocated=lambda n: 8)
    assert parsed.rows == 3
    assert parsed.values[0].tolist() == [1, 0, 3, 0, 0, 0, 0, 0]
    assert parsed.validity[0].tolist() == [True, False, True] + [False] * 5
    assert parsed.values[1].tolist() == [0, 1, 2, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("body,kind,offset", [
    ("1|2|\n3|4x|\n5|6|\n", Int64, 5),
    ("1|2|\n3|4|\n5|+6-|\n", Int64, 10),
    ("1|2.5|\n3|4.a|\n", Decimal(2), 7),
    ("1|t|\n3|yes|\n", Boolean, 5),
    ("1|1992-01-01|\n3|1992-1-1|\n", Date32, 14),
])
def test_a_field_that_does_not_parse_raises_with_its_byte_offset(
        tmp_path, body, kind, offset):
    path = tmp_path / "bad.tbl"
    path.write_text(body)
    sch = schema(("a", Int64), ("b", kind))
    with pytest.raises(IoError) as host:
        native.scan_file(str(path), sch, ["a", "b"], threads=1)
    with pytest.raises(IoError) as card:
        twin_scan(str(path), sch, ["a", "b"])
    assert f"row byte offset {offset}," in str(host.value)
    assert f"row byte offset {offset}) col 1 " in str(card.value)
    assert str(path) in str(card.value)


def test_the_first_failing_row_is_reported(tmp_path):
    path = tmp_path / "two_bad.tbl"
    path.write_text("1|\nx|\n2|\ny|\n")
    with pytest.raises(IoError, match=r"row byte offset 3\)"):
        twin_scan(str(path), schema(("a", Int64),), ["a"])


# -- the dictionary step's exact resolution of shared hashes ------------------


def _fields(values):
    blob = "".join(values).encode()
    lens = [len(v.encode()) for v in values]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    data = torch.zeros(tbl_parse.padded_bytes(len(blob)), dtype=torch.uint8)
    data[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    return (data, torch.from_numpy(starts),
            torch.tensor(lens, dtype=torch.int32))


@pytest.mark.parametrize("injected", ["all_equal", "two_share", "none"])
def test_dictionary_step_resolves_injected_hash_collisions(injected):
    values = ["beta", "alpha", "beta", "gamma", "", "alpha", "delta", "gamma",
              "beta", "zeta"]
    data, starts, lens = _fields(values)
    real = {v: i for i, v in enumerate(sorted(set(values)))}
    if injected == "all_equal":
        hashes = torch.full((len(values),), 42, dtype=torch.int64)
        extra = len(set(values)) - 1
    elif injected == "two_share":  # alpha and gamma collide
        hashes = torch.tensor([7 if v in ("alpha", "gamma") else
                               100 + real[v] for v in values],
                              dtype=torch.int64)
        extra = 1
    else:
        hashes = torch.tensor([100 + real[v] for v in values],
                              dtype=torch.int64)
        extra = 0
    sv, codes, collisions = tbl_parse.dictionary_encode(data, starts, lens,
                                                        hashes)
    assert list(sv.strings()) == sorted(set(values))
    assert codes.tolist() == [real[v] for v in values]
    assert collisions == extra


def test_scan_counts_hash_collisions(tmp_path, monkeypatch):
    """A scan whose hashes collide gives the host's codes, and the count
    reaches ``ingest.scan_counters()``."""
    path = tmp_path / "c.tbl"
    path.write_text("".join(f"{i}|v{i % 7}|\n" for i in range(50)))
    sch = schema(("k", Int64), ("s", Utf8))
    src = TblSource(str(path), sch, device="cpu")
    real = tbl_parse.dictionary_encode
    monkeypatch.setattr(tbl_parse, "dictionary_encode",
                        lambda d, s, l, h: real(d, s, l, h % 3))
    before = ingest.scan_counters()["hash_collisions"]
    batches = list(src._scan_on_card(0, ["s"], sch.project(["s"])))
    host = list(TblSource(str(path), sch, device="cpu")._scan_direct(0, ["s"]))
    assert torch.equal(batches[0].columns[0].values,
                       host[0].columns[0].values)
    assert ingest.scan_counters()["hash_collisions"] - before == 4


# -- the path choice --------------------------------------------------------


@pytest.mark.parametrize("case", ["card", "cpu_device", "float_column",
                                  "streamed_file"])
def test_scan_path_choice(tmp_path, monkeypatch, case):
    path = tmp_path / "p.tbl"
    path.write_text("1|2.5|x|\n2|3.5|y|\n")
    sch = schema(("a", Int64), ("f", Float64), ("s", Utf8))
    device = "cpu" if case == "cpu_device" else "cuda"
    if case == "streamed_file":
        monkeypatch.setattr(text, "STREAM_CHUNK_BYTES", 8)
    src = TblSource(str(path), sch, device=device)
    names = ["a", "f", "s"] if case == "float_column" else ["a", "s"]
    assert src.scan_path(0, names) == (None if case == "card" else case)


def test_cpu_scans_stay_on_the_host_scanner(tmp_path, monkeypatch):
    """A CPU device's scan runs ``native.scan_file`` and never the card's
    path, and is counted with its reason."""
    path = tmp_path / "h.tbl"
    path.write_text("1|x|\n2|y|\n")
    sch = schema(("a", Int64), ("s", Utf8))

    def refuse(*a, **k):
        raise AssertionError("the CPU device parsed through tbl_parse")

    monkeypatch.setattr(tbl_parse, "parse", refuse)
    calls = []
    real = native.scan_file
    monkeypatch.setattr(native, "scan_file",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    before = ingest.scan_counters()
    reset_port_caches()
    batches = list(TblSource(str(path), sch, device="cpu").scan(0))
    after = ingest.scan_counters()
    assert calls and batches[0].num_rows.item() == 2
    assert after["scans_on_host"] - before["scans_on_host"] == 1
    assert after.get("scans_on_host.cpu_device", 0) - before.get(
        "scans_on_host.cpu_device", 0) == 1
    assert after["scans_on_card"] == before["scans_on_card"]


def test_device_parsed_bytes_reach_the_scan_metrics():
    from ballista_tpu_torch.ingest.phases import PhaseRecorder, bind
    from ballista_tpu_torch.observability.metrics import MetricsSet

    m = MetricsSet()
    before = ingest.scan_counters()["device_parsed_bytes"]
    with bind(PhaseRecorder(m)):
        ingest.count("device_parsed_bytes", 1234)
        ingest.count("scans_on_card")
    assert m.values()["device_parsed_bytes"] == 1234
    assert "scans_on_card" not in m.values()
    assert ingest.scan_counters()["device_parsed_bytes"] - before == 1234


# -- the card's scan path on the twin, against the host path's batches -------


def assert_same_batches(got, want, label=""):
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        assert g.capacity == w.capacity, label
        assert torch.equal(g.selection, w.selection), label
        assert int(g.num_rows) == int(w.num_rows), label
        for f, gc, wc in zip(w.schema.fields, g.columns, w.columns):
            assert gc.values.dtype == wc.values.dtype, (label, f.name)
            assert torch.equal(gc.values, wc.values), (label, f.name)
            assert (gc.validity is None) == (wc.validity is None), \
                (label, f.name)
            if wc.validity is not None:
                assert torch.equal(gc.validity, wc.validity), (label, f.name)
            assert gc.dictionary is wc.dictionary, (label, f.name)


@pytest.mark.parametrize("capacity", [8, 1 << 20])
def test_card_path_batches_equal_host_path_batches(sf001, capacity):
    root, _ = sf001
    for table, names in (("orders", ["o_orderkey", "o_orderdate",
                                     "o_orderpriority", "o_totalprice"]),
                         ("customer", TPCH_SCHEMAS["customer"].names())):
        path = os.path.join(root, f"{table}.tbl")
        sch = TPCH_SCHEMAS[table]
        src = TblSource(path, sch, batch_capacity=capacity, device="cpu")
        sub = sch.project(names)
        for run in range(2):  # the second compares dictionaries by bytes
            card = list(src._scan_on_card(0, names, sub))
            host = list(src._scan_direct(0, names))
            assert_same_batches(card, host, f"{table} run {run}")


def test_card_path_batches_with_nulls_equal_host_path(tmp_path):
    sch, delim, header, body = EDGE_CASES["nulls"]
    path = str(tmp_path / "nulls.tbl")
    with open(path, "w") as f:
        f.write(body)
    src = TblSource(path, sch, batch_capacity=2, device="cpu")
    names = sch.names()
    assert_same_batches(list(src._scan_on_card(0, names, sch)),
                        list(src._scan_direct(0, names)))


def test_card_path_multi_file_table_remaps_onto_table_dictionaries(tmp_path):
    d = tmp_path / "t"
    d.mkdir()
    (d / "part0.tbl").write_text("1|b|\n2|d|\n3|b|\n")
    (d / "part1.tbl").write_text("4|a|\n5|c|\n6|d|\n\n")
    sch = schema(("k", Int64), ("s", Utf8))
    src = TblSource(str(d), sch, device="cpu")
    for p in range(2):
        card = list(src._scan_on_card(p, ["s", "k"], sch.project(["s", "k"])))
        host = list(src._scan_direct(p, ["s", "k"]))
        assert_same_batches(card, host, f"part {p}")
    assert list(src._dicts["s"].values) == ["a", "b", "c", "d"]


def test_card_path_csv_and_empty_file(tmp_path):
    path = tmp_path / "x.csv"
    path.write_text("a,b\n1,x\n2,\n")
    sch = schema(("a", Int64), ("b", Utf8))
    src = CsvSource(str(path), sch, device="cpu")
    assert_same_batches(list(src._scan_on_card(0, ["a", "b"], sch)),
                        list(src._scan_direct(0, ["a", "b"])))
    empty = tmp_path / "e.tbl"
    empty.write_text("")
    src = TblSource(str(empty), sch, device="cpu")
    assert_same_batches(list(src._scan_on_card(0, ["a", "b"], sch)),
                        list(src._scan_direct(0, ["a", "b"])))


@pytest.mark.parametrize("q", QUERIES)
def test_queries_through_the_card_path_equal_the_host_path(sf001, monkeypatch,
                                                            q):
    """The six queries with every scan forced through the card's path
    (its twin, on the CPU) answer as the host path does, and EXPLAIN
    ANALYZE shows the scans' ``device_parsed_bytes``."""
    from ballista_tpu_torch.client import BallistaContext

    root, _ = sf001
    with open(os.path.join(ROOT, "qbench", "queries", f"{q}.sql")) as f:
        sql = f.read()
    answers = {}
    for forced in (False, True):
        if forced:
            monkeypatch.setattr(text.DelimitedSource, "scan_path",
                                lambda self, partition, names: None)
        reset_port_caches()
        ctx = BallistaContext.standalone(device="cpu")
        for t in TABLES:
            ctx.register_source(t, TblSource(os.path.join(root, f"{t}.tbl"),
                                             TPCH_SCHEMAS[t], device="cpu"))
        before = ingest.scan_counters()
        answers[forced] = ctx.sql(sql).to_pydict()
        after = ingest.scan_counters()
        on_card = after["scans_on_card"] - before["scans_on_card"]
        assert (on_card > 0) == forced
        if forced:
            reset_port_caches()  # a table-cache hit parses nothing
            assert "device_parsed_bytes=" in ctx.sql(sql).explain_analyze()
    assert list(answers[True]) == list(answers[False])
    for k in answers[False]:
        assert np.array_equal(np.asarray(answers[True][k]),
                              np.asarray(answers[False][k])), k


def test_stage_text_pads_and_finds_the_header(tmp_path):
    path = tmp_path / "s.csv"
    path.write_bytes(b"h1,h2\n1,2\n")
    data, size, begin = text.stage_text(str(path), CPU, True)
    assert (size, begin) == (10, 6)
    assert data.numel() == tbl_parse.padded_bytes(10) == 64
    assert bytes(data[:size].tolist()) == b"h1,h2\n1,2\n"
    _, _, begin = text.stage_text(str(path), CPU, False)
    assert begin == 0


def test_kernel_inputs_are_checked():
    from ballista_tpu_torch.errors import ExecutionError

    data = torch.zeros(64, dtype=torch.uint8)
    ok = dict(data=data, size=10, begin=0, delimiter=ord("|"), kinds=[0],
              scales=[0], wanted=[0])
    for bad in (dict(kinds=[5]), dict(delimiter=10), dict(size=100),
                dict(begin=11), dict(wanted=[1]),
                dict(data=torch.zeros(64, dtype=torch.int32))):
        with pytest.raises(ExecutionError):
            tbl_parse.parse(**{**ok, **bad})


# -- on the card ---------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(python3 -m ballista_tpu_torch.testing.card_checks "
                    "runs them on the card)")


def test_cuda_kernels_equal_twin_and_host_scanner(tmp_path):
    _needs_card()
    dev = torch.device("cuda")
    cases = dict(EDGE_CASES)
    cases["many"] = None
    for case in sorted(cases):
        if case == "many":
            path, sch = _many_distinct(tmp_path)
            delim, header = "|", False
        else:
            sch, delim, header, body = cases[case]
            path = str(tmp_path / f"{case}.txt")
            with open(path, "w", encoding="utf-8") as f:
                f.write(body)
        names = sch.names()
        before = tbl_parse.launch_count
        card = twin_scan(path, sch, names, delim, header, device=dev,
                         rows_allocated=lambda n: n + 3)
        torch.cuda.synchronize()
        twin = twin_scan(path, sch, names, delim, header,
                         rows_allocated=lambda n: n + 3)
        assert_same_as_host(card, path, sch, names, delim, header, case)
        for j in range(len(names)):
            assert torch.equal(card.values[j].cpu(), twin.values[j]), case
            cv, tv = card.validity[j], twin.validity[j]
            assert (cv is None) == (tv is None), case
            if cv is not None:
                assert torch.equal(cv.cpu(), tv), case
        if card.rows:
            assert tbl_parse.launch_count > before, case


def test_cuda_query_projections_on_card(sf001):
    _needs_card()
    root, projections = sf001
    for table, projs in projections.items():
        path = os.path.join(root, f"{table}.tbl")
        for names in projs:
            card = twin_scan(path, TPCH_SCHEMAS[table], list(names),
                             device=torch.device("cuda"))
            assert_same_as_host(card, path, TPCH_SCHEMAS[table], list(names),
                                label=f"{table} {names}")


def test_cuda_bad_field_raises_with_byte_offset(tmp_path):
    _needs_card()
    path = tmp_path / "bad.tbl"
    path.write_text("1|2|\n3|4x|\n5|6|\n")
    with pytest.raises(IoError, match=r"row byte offset 5\) col 1"):
        twin_scan(str(path), schema(("a", Int64), ("b", Int64)), ["a", "b"],
                  device=torch.device("cuda"))


def test_cuda_cold_q1_q10_parse_every_scan_on_the_card(sf001, monkeypatch):
    _needs_card()
    from ballista_tpu_torch.client import BallistaContext

    root, _ = sf001
    monkeypatch.setenv("BALLISTA_TABLE_CACHE", "off")
    answers = {}
    for device in ("cpu", "cuda"):
        reset_port_caches()
        ctx = BallistaContext.standalone(device=device)
        for t in TABLES:
            ctx.register_source(t, TblSource(os.path.join(root, f"{t}.tbl"),
                                             TPCH_SCHEMAS[t], device=device))
        before = ingest.scan_counters()
        for q in ("q1", "q10"):
            with open(os.path.join(ROOT, "qbench", "queries",
                                   f"{q}.sql")) as f:
                sql = f.read()
            for _ in range(2):  # the second scan compares dictionary bytes
                answers[(device, q)] = ctx.sql(sql).to_pydict()
        after = ingest.scan_counters()
        on_card = after["scans_on_card"] - before["scans_on_card"]
        on_host = after["scans_on_host"] - before["scans_on_host"]
        if device == "cuda":
            assert on_card >= 6 and on_host == 0, (on_card, on_host)
            assert after["device_parsed_bytes"] > before[
                "device_parsed_bytes"]
        else:
            assert on_card == 0 and on_host >= 6
        if device == "cuda":  # EXPLAIN ANALYZE shows the scans' bytes
            reset_port_caches()
            with open(os.path.join(ROOT, "qbench", "queries",
                                   "q6.sql")) as f:
                text_out = ctx.sql(f.read()).explain_analyze()
            assert "device_parsed_bytes" in text_out, text_out
    for q in ("q1", "q10"):
        got, want = answers[("cuda", q)], answers[("cpu", q)]
        assert list(got) == list(want), q
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), \
                (q, k)
