"""Arrow Flight front-end: the any-language data plane.

The reference's cross-language story is Arrow Flight — its JDBC driver
opens a FlightClient and sends the RAW SQL BYTES as the Ticket of a
``DoGet``, then reads the schema-first FlightData stream (reference:
jvm/jdbc/.../FlightStatement.java:44-63, Driver.java:33-47; server side
flight_service.rs:80-228). Round 2 shipped only a bespoke length-prefixed
socket protocol, which no foreign client can speak; this module restores
the interop contract with a REAL Arrow Flight gRPC server (pyarrow.flight)
fronting the engine:

- Ticket = raw SQL bytes        -> plan + execute, stream the result table
  (exactly the JDBC driver's byte exchange);
- Ticket = serialized pb.Action -> FetchPartition / FetchShufflePartition
  streams a materialized partition file (Flight-spoken twin of the raw
  data plane in distributed/dataplane.py, which stays the executor<->
  executor fast path).

Results stream as standard Arrow IPC record batches, so any Flight
client (Java/C++/Go/Python) can consume them without this codebase.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

try:  # pyarrow is optional at runtime; gate cleanly when absent
    import pyarrow as pa
    import pyarrow.flight as paflight

    _PA_ERR = None
except Exception as _e:  # noqa: BLE001 - record why it's unavailable
    pa, paflight = None, None
    _PA_ERR = _e

from ..errors import IoError
from ..proto import ballista_pb2 as pb


def available() -> bool:
    return paflight is not None


def _table_from_pydict(data: dict) -> "pa.Table":
    """Engine result (numpy logical arrays) -> Arrow table. Object
    arrays (strings with None) and datetime64[D] map to utf8/date32."""
    cols = {}
    for name, arr in data.items():
        a = np.asarray(arr)
        if a.dtype == object:
            cols[name] = pa.array(a.tolist(), type=pa.string())
        elif np.issubdtype(a.dtype, np.datetime64):
            # date32 results decode as datetime64[D]; timestamp_ns as
            # datetime64[ns] — preserve sub-day precision for the latter
            if np.datetime_data(a.dtype)[0] == "D":
                cols[name] = pa.array(a)
            else:
                cols[name] = pa.array(a.astype("datetime64[ns]"))
        else:
            cols[name] = pa.array(a)
    return pa.table(cols)


class BallistaFlightServer(paflight.FlightServerBase if paflight else object):
    """Flight service over a query-execution callback + partition store.

    ``execute_sql(sql) -> dict[str, np.ndarray]`` runs a query (standalone
    context or cluster client — the server doesn't care); ``work_dir``
    enables partition-fetch tickets against materialized stage output.
    """

    def __init__(self, location: str,
                 execute_sql=None, work_dir: Optional[str] = None,
                 **kwargs):
        if paflight is None:  # pragma: no cover - env without pyarrow
            raise IoError(f"pyarrow.flight unavailable: {_PA_ERR}")
        super().__init__(location, **kwargs)
        self._execute_sql = execute_sql
        self._work_dir = work_dir

    # -- DoGet: the one RPC the reference JDBC driver uses ------------------

    def do_get(self, context, ticket):
        payload = ticket.ticket
        action = pb.Action()
        parsed = False
        try:
            action.ParseFromString(payload)
            parsed = action.WhichOneof("action_type") in (
                "fetch_partition", "fetch_shuffle", "sql",
            )
        except Exception:  # noqa: BLE001 - not a proto: raw SQL ticket
            parsed = False
        if parsed and action.WhichOneof("action_type") == "fetch_partition":
            return self._get_partition(
                action.fetch_partition.job_id,
                action.fetch_partition.stage_id,
                action.fetch_partition.partition_id, None,
            )
        if parsed and action.WhichOneof("action_type") == "fetch_shuffle":
            fs = action.fetch_shuffle
            return self._get_partition(
                fs.producer.job_id, fs.producer.stage_id,
                fs.producer.partition_id, fs.output_partition,
            )
        sql = (action.sql if parsed and
               action.WhichOneof("action_type") == "sql"
               else payload.decode("utf-8", errors="replace"))
        return self._get_sql(sql)

    def _get_sql(self, sql: str):
        if self._execute_sql is None:
            raise paflight.FlightServerError("this endpoint serves no SQL")
        data = self._execute_sql(sql)
        if hasattr(data, "columns") and hasattr(data, "to_dict"):  # pandas
            table = pa.Table.from_pandas(data, preserve_index=False)
        else:
            table = _table_from_pydict(data)
        return paflight.RecordBatchStream(table)

    def _get_partition(self, job_id: str, stage_id: int, partition_id: int,
                       shuffle_output: Optional[int]):
        if self._work_dir is None:
            raise paflight.FlightServerError(
                "this endpoint serves no partitions")
        from .dataplane import partition_path, shuffle_path

        if shuffle_output is None:
            path = partition_path(self._work_dir, job_id, stage_id,
                                  partition_id)
        else:
            path = shuffle_path(self._work_dir, job_id, stage_id,
                                partition_id, shuffle_output)
        # partitions are materialized AS Arrow IPC (io/ipc.py) — stream
        # format from the chunked writers, legacy file format from older
        # data — so they stream verbatim, dictionary encoding preserved
        from ..io import ipc as _ipc

        reader = _ipc.open_arrow_reader(path)
        return paflight.RecordBatchStream(reader.read_all())

    # -- discovery RPCs (minimal but spec-conformant) -----------------------

    def get_flight_info(self, context, descriptor):
        # SQL rides in the command descriptor; the endpoint echoes it as
        # the DoGet ticket (standard Flight submit-then-fetch shape)
        ticket = paflight.Ticket(descriptor.command or b"")
        endpoint = paflight.FlightEndpoint(ticket, [])
        return paflight.FlightInfo(
            pa.schema([]), descriptor, [endpoint], -1, -1,
        )

    def list_flights(self, context, criteria):
        return iter(())


def serve_flight(host: str = "0.0.0.0", port: int = 0,
                 execute_sql=None, work_dir: Optional[str] = None):
    """Start a Flight server on a background thread; returns
    (server, bound_port)."""
    location = f"grpc://{host}:{port}"
    server = BallistaFlightServer(location, execute_sql=execute_sql,
                                  work_dir=work_dir)
    t = threading.Thread(target=server.serve, daemon=True,
                         name="flight-server")
    t.start()
    return server, server.port
