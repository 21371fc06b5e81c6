"""Plan/expression <-> protobuf serde.

The port of the JAX package's ``serde.py``, over the same wire types (the
port's ``proto/`` is a byte-identical copy; both register one
``ballista.proto``). The protobuf carries no device, so deserializing a
plan or a source takes an explicit ``device`` (keyword, required) and
hands it to every source and operator it builds (the mesh operators
lay their slots out on it). A system-table source is rebuilt from the
rows it shipped with.

Equivalent of the reference's serde layer (reference:
rust/core/src/serde/logical_plan/{to_proto.rs,from_proto.rs} and
serde/physical_plan/*; its roundtrip tests at serde/logical_plan/mod.rs:
20-920 are the model for tests/test_serde.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .datatypes import (
    Boolean,
    DataType,
    Date32,
    Decimal,
    Field,
    Float32,
    Float64,
    Int32,
    Int64,
    Schema,
    Utf8,
)
from .errors import SerdeError
from . import expr as ex
from . import logical as lp
from .proto import ballista_pb2 as pb

# ---------------------------------------------------------------------------
# Types
# ---------------------------------------------------------------------------


def dtype_to_proto(dt: DataType) -> pb.DataType:
    p = pb.DataType(kind=dt.kind, scale=dt.scale)
    if dt.kind == "list":
        p.element_kind = dt.element.kind
        p.element_scale = dt.element.scale
        p.length = dt.length
    return p


def dtype_from_proto(p: pb.DataType) -> DataType:
    if p.kind == "decimal":
        return Decimal(p.scale)
    if p.kind == "list":
        from .datatypes import FixedSizeList

        elem = (Decimal(p.element_scale) if p.element_kind == "decimal"
                else DataType(p.element_kind))
        return FixedSizeList(elem, p.length)
    return DataType(p.kind)


def schema_to_proto(s: Schema) -> pb.Schema:
    return pb.Schema(
        fields=[
            pb.Field(name=f.name, dtype=dtype_to_proto(f.dtype), nullable=f.nullable)
            for f in s.fields
        ]
    )


def schema_from_proto(p: pb.Schema) -> Schema:
    return Schema(
        [Field(f.name, dtype_from_proto(f.dtype), f.nullable) for f in p.fields]
    )


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


def expr_to_proto(e: ex.Expr) -> pb.LogicalExprNode:
    n = pb.LogicalExprNode()
    if isinstance(e, ex.ColumnRef):
        n.column.column = e.column
        n.column.relation = e.relation or ""
    elif isinstance(e, ex.Literal):
        sv = n.literal
        sv.dtype.CopyFrom(dtype_to_proto(e.dtype))
        if e.value is None:
            sv.null_value = True
        elif e.dtype == Boolean:
            sv.bool_value = bool(e.value)
        elif e.dtype == Date32:
            sv.date_value = int(e.value)
        elif e.dtype.kind == "utf8":
            sv.string_value = str(e.value)
        elif e.dtype.is_integer or e.dtype.kind == "decimal":
            sv.int_value = int(e.value)
        else:
            sv.float_value = float(e.value)
    elif isinstance(e, ex.BinaryExpr):
        n.binary.left.CopyFrom(expr_to_proto(e.left))
        n.binary.op = e.op
        n.binary.right.CopyFrom(expr_to_proto(e.right))
    elif isinstance(e, ex.Not):
        n.not_expr.CopyFrom(expr_to_proto(e.expr))
    elif isinstance(e, ex.IsNull):
        n.is_null.CopyFrom(expr_to_proto(e.expr))
    elif isinstance(e, ex.IsNotNull):
        n.is_not_null.CopyFrom(expr_to_proto(e.expr))
    elif isinstance(e, ex.Alias):
        n.alias.expr.CopyFrom(expr_to_proto(e.expr))
        n.alias.alias = e.alias_name
    elif isinstance(e, ex.Cast):
        n.cast.expr.CopyFrom(expr_to_proto(e.expr))
        n.cast.dtype.CopyFrom(dtype_to_proto(e.dtype))
    elif isinstance(e, ex.InList):
        n.in_list.expr.CopyFrom(expr_to_proto(e.expr))
        for item in e.list:
            n.in_list.list.append(expr_to_proto(item))
        n.in_list.negated = e.negated
    elif isinstance(e, ex.Like):
        n.like.expr.CopyFrom(expr_to_proto(e.expr))
        n.like.pattern = e.pattern
        n.like.negated = e.negated
    elif isinstance(e, ex.Case):
        if e.base is not None:
            n.case_expr.base.CopyFrom(expr_to_proto(e.base))
        for w, t in e.branches:
            b = n.case_expr.branches.add()
            b.when.CopyFrom(expr_to_proto(w))
            b.then.CopyFrom(expr_to_proto(t))
        if e.otherwise is not None:
            n.case_expr.otherwise.CopyFrom(expr_to_proto(e.otherwise))
    elif isinstance(e, ex.ScalarFunction):
        n.scalar_fn.fn = e.fn
        for a in e.args:
            n.scalar_fn.args.append(expr_to_proto(a))
    elif isinstance(e, ex.AggregateExpr):
        n.aggregate.fn = e.fn
        n.aggregate.expr.CopyFrom(expr_to_proto(e.expr))
        n.aggregate.is_star = e.is_star
    elif isinstance(e, ex.SortExpr):
        n.sort.expr.CopyFrom(expr_to_proto(e.expr))
        n.sort.ascending = e.ascending
        n.sort.nulls_first = e.nulls_first
    else:
        raise SerdeError(f"cannot serialize expr {type(e).__name__}")
    return n


def expr_from_proto(n: pb.LogicalExprNode) -> ex.Expr:
    kind = n.WhichOneof("expr_type")
    if kind == "column":
        return ex.ColumnRef(n.column.column, n.column.relation or None)
    if kind == "literal":
        sv = n.literal
        dt = dtype_from_proto(sv.dtype)
        which = sv.WhichOneof("value")
        if which == "null_value":
            return ex.Literal(None, dt)
        if which == "bool_value":
            return ex.Literal(sv.bool_value, dt)
        if which == "date_value":
            return ex.Literal(sv.date_value, dt)
        if which == "string_value":
            return ex.Literal(sv.string_value, dt)
        if which == "int_value":
            return ex.Literal(sv.int_value, dt)
        if which == "float_value":
            return ex.Literal(sv.float_value, dt)
        raise SerdeError("literal without value")
    if kind == "binary":
        return ex.BinaryExpr(
            expr_from_proto(n.binary.left), n.binary.op,
            expr_from_proto(n.binary.right),
        )
    if kind == "not_expr":
        return ex.Not(expr_from_proto(n.not_expr))
    if kind == "is_null":
        return ex.IsNull(expr_from_proto(n.is_null))
    if kind == "is_not_null":
        return ex.IsNotNull(expr_from_proto(n.is_not_null))
    if kind == "alias":
        return ex.Alias(expr_from_proto(n.alias.expr), n.alias.alias)
    if kind == "cast":
        return ex.Cast(expr_from_proto(n.cast.expr), dtype_from_proto(n.cast.dtype))
    if kind == "in_list":
        return ex.InList(
            expr_from_proto(n.in_list.expr),
            [expr_from_proto(i) for i in n.in_list.list],
            n.in_list.negated,
        )
    if kind == "like":
        return ex.Like(expr_from_proto(n.like.expr), n.like.pattern, n.like.negated)
    if kind == "case_expr":
        base = (
            expr_from_proto(n.case_expr.base)
            if n.case_expr.HasField("base") else None
        )
        otherwise = (
            expr_from_proto(n.case_expr.otherwise)
            if n.case_expr.HasField("otherwise") else None
        )
        return ex.Case(
            base,
            [(expr_from_proto(b.when), expr_from_proto(b.then))
             for b in n.case_expr.branches],
            otherwise,
        )
    if kind == "scalar_fn":
        return ex.ScalarFunction(
            n.scalar_fn.fn, [expr_from_proto(a) for a in n.scalar_fn.args]
        )
    if kind == "aggregate":
        return ex.AggregateExpr(
            n.aggregate.fn, expr_from_proto(n.aggregate.expr), n.aggregate.is_star
        )
    if kind == "sort":
        return ex.SortExpr(
            expr_from_proto(n.sort.expr), n.sort.ascending, n.sort.nulls_first
        )
    raise SerdeError(f"unknown expr node {kind}")


# ---------------------------------------------------------------------------
# Table sources
# ---------------------------------------------------------------------------


def source_to_proto(src: lp.TableSource, primary_key: Optional[str] = None
                    ) -> pb.TableSourceDesc:
    d = src.source_descriptor()
    return pb.TableSourceDesc(
        kind=d.get("kind", ""),
        path=d.get("path", ""),
        delimiter=d.get("delimiter", ""),
        has_header=bool(d.get("has_header", False)),
        schema=schema_to_proto(src.table_schema()),
        primary_key=primary_key or "",
        num_partitions=d.get("num_partitions", 0),
        # system sources: the snapshot rows, materialized at
        # serialization time (observability/systables.py)
        payload=d.get("rows_json", "").encode(),
    )


def source_from_proto(p: pb.TableSourceDesc, *, device) -> lp.TableSource:
    from .io import CsvSource, ParquetSource, TblSource

    schema = schema_from_proto(p.schema)
    if p.kind == "tbl":
        return TblSource(p.path, schema, device=device)
    if p.kind == "csv":
        return CsvSource(p.path, schema, has_header=p.has_header,
                         delimiter=p.delimiter or ",", device=device)
    if p.kind == "parquet":
        return ParquetSource(p.path, schema, device=device)
    if p.kind == "system":
        import json

        from .observability.systables import SystemTableSource

        return SystemTableSource(p.path, rows=json.loads(p.payload.decode()),
                                 device=device)
    raise SerdeError(f"source kind {p.kind!r} is not remotable")


# ---------------------------------------------------------------------------
# Logical plans
# ---------------------------------------------------------------------------


def plan_to_proto(plan: lp.LogicalPlan) -> pb.LogicalPlanNode:
    n = pb.LogicalPlanNode()
    if isinstance(plan, lp.TableScan):
        n.scan.table_name = plan.table_name
        n.scan.source.CopyFrom(source_to_proto(plan.source))
        if plan.projection is not None:
            n.scan.has_projection = True
            n.scan.projection.extend(plan.projection)
    elif isinstance(plan, lp.Projection):
        n.projection.input.CopyFrom(plan_to_proto(plan.input))
        for e in plan.exprs:
            n.projection.exprs.append(expr_to_proto(e))
    elif isinstance(plan, lp.Filter):
        n.filter.input.CopyFrom(plan_to_proto(plan.input))
        n.filter.predicate.CopyFrom(expr_to_proto(plan.predicate))
    elif isinstance(plan, lp.Aggregate):
        n.aggregate.input.CopyFrom(plan_to_proto(plan.input))
        for e in plan.group_exprs:
            n.aggregate.group_exprs.append(expr_to_proto(e))
        for e in plan.agg_exprs:
            n.aggregate.agg_exprs.append(expr_to_proto(e))
    elif isinstance(plan, lp.Join):
        n.join.left.CopyFrom(plan_to_proto(plan.left))
        n.join.right.CopyFrom(plan_to_proto(plan.right))
        for l, r in plan.on:
            o = n.join.on.add()
            o.left_col = l
            o.right_col = r
        n.join.how = plan.how
        n.join.null_aware = plan.null_aware
    elif isinstance(plan, lp.Sort):
        n.sort.input.CopyFrom(plan_to_proto(plan.input))
        for e in plan.sort_exprs:
            n.sort.sort_exprs.append(expr_to_proto(e))
    elif isinstance(plan, lp.Limit):
        n.limit.input.CopyFrom(plan_to_proto(plan.input))
        n.limit.n = plan.n
    elif isinstance(plan, lp.Repartition):
        n.repartition.input.CopyFrom(plan_to_proto(plan.input))
        n.repartition.num_partitions = plan.num_partitions
        for e in plan.hash_exprs or []:
            n.repartition.hash_exprs.append(expr_to_proto(e))
    elif isinstance(plan, lp.EmptyRelation):
        n.empty.produce_one_row = plan.produce_one_row
    elif isinstance(plan, lp.Explain):
        n.explain.input.CopyFrom(plan_to_proto(plan.input))
        n.explain.verbose = plan.verbose
        n.explain.analyze = plan.analyze
    else:
        raise SerdeError(f"cannot serialize plan {type(plan).__name__}")
    return n


def plan_from_proto(n: pb.LogicalPlanNode, *, device) -> lp.LogicalPlan:
    """Plan node -> logical plan whose sources live on ``device``."""
    return _plan_from_proto(n, device)


def _plan_from_proto(n: pb.LogicalPlanNode, device) -> lp.LogicalPlan:
    def plan_from_proto(m):  # threads the device through the recursion
        return _plan_from_proto(m, device)

    kind = n.WhichOneof("plan_type")
    if kind == "scan":
        src = source_from_proto(n.scan.source, device=device)
        proj = tuple(n.scan.projection) if n.scan.has_projection else None
        return lp.TableScan(n.scan.table_name, src, proj)
    if kind == "projection":
        return lp.Projection(
            [expr_from_proto(e) for e in n.projection.exprs],
            plan_from_proto(n.projection.input),
        )
    if kind == "filter":
        return lp.Filter(
            expr_from_proto(n.filter.predicate), plan_from_proto(n.filter.input)
        )
    if kind == "aggregate":
        return lp.Aggregate(
            [expr_from_proto(e) for e in n.aggregate.group_exprs],
            [expr_from_proto(e) for e in n.aggregate.agg_exprs],
            plan_from_proto(n.aggregate.input),
        )
    if kind == "join":
        return lp.Join(
            plan_from_proto(n.join.left),
            plan_from_proto(n.join.right),
            [(o.left_col, o.right_col) for o in n.join.on],
            n.join.how,
            n.join.null_aware,
        )
    if kind == "sort":
        return lp.Sort(
            [expr_from_proto(e) for e in n.sort.sort_exprs],
            plan_from_proto(n.sort.input),
        )
    if kind == "limit":
        return lp.Limit(n.limit.n, plan_from_proto(n.limit.input))
    if kind == "repartition":
        hx = [expr_from_proto(e) for e in n.repartition.hash_exprs]
        return lp.Repartition(
            plan_from_proto(n.repartition.input),
            n.repartition.num_partitions,
            hx or None,
        )
    if kind == "empty":
        return lp.EmptyRelation(n.empty.produce_one_row)
    if kind == "explain":
        return lp.Explain(plan_from_proto(n.explain.input), n.explain.verbose,
                          n.explain.analyze)
    raise SerdeError(f"unknown plan node {kind}")


# ---------------------------------------------------------------------------
# Physical plans
# ---------------------------------------------------------------------------


def physical_to_proto(plan) -> pb.PhysicalPlanNode:
    from .physical.aggregate import HashAggregateExec
    from .physical.explain import ExplainAnalyzeExec, ExplainExec
    from .physical.join import JoinExec
    from .physical.mesh_agg import MeshAggExec, MeshJoinExec
    from .physical import operators as ops
    from .physical.shuffle import ShuffleReaderExec, UnresolvedShuffleExec

    n = pb.PhysicalPlanNode()
    if isinstance(plan, ops.ScanExec):
        n.scan.table_name = plan.table_name
        n.scan.source.CopyFrom(source_to_proto(plan.source))
        if plan.projection is not None:
            n.scan.has_projection = True
            n.scan.projection.extend(plan.projection)
    elif isinstance(plan, ops.ProjectionExec):
        n.projection.input.CopyFrom(physical_to_proto(plan.child))
        for e in plan.exprs:
            n.projection.exprs.append(expr_to_proto(e))
    elif isinstance(plan, ops.FilterExec):
        n.filter.input.CopyFrom(physical_to_proto(plan.child))
        n.filter.predicate.CopyFrom(expr_to_proto(plan.predicate))
    elif isinstance(plan, HashAggregateExec):
        n.hash_aggregate.input.CopyFrom(physical_to_proto(plan.child))
        n.hash_aggregate.mode = plan.mode
        for e in plan.group_exprs:
            n.hash_aggregate.group_exprs.append(expr_to_proto(e))
        for e in plan.agg_exprs:
            n.hash_aggregate.agg_exprs.append(expr_to_proto(e))
        n.hash_aggregate.group_capacity = plan.group_capacity
    elif isinstance(plan, JoinExec):
        n.join.build.CopyFrom(physical_to_proto(plan.build))
        n.join.probe.CopyFrom(physical_to_proto(plan.probe))
        for l, r in plan.on:
            o = n.join.on.add()
            o.left_col = l
            o.right_col = r
        n.join.how = plan.how
        n.join.null_aware = plan.null_aware
        n.join.partitioned = plan.partitioned
        n.join.adaptive_note = plan.adaptive_note or ""
    elif isinstance(plan, MeshJoinExec):
        n.mesh_join.build_producer.CopyFrom(
            physical_to_proto(plan.build_producer))
        n.mesh_join.probe_producer.CopyFrom(
            physical_to_proto(plan.probe_producer))
        for l, r in plan.on:
            o = n.mesh_join.on.add()
            o.left_col = l
            o.right_col = r
        n.mesh_join.how = plan.how
        n.mesh_join.n_devices = plan.n_devices
        n.mesh_join.null_aware = plan.null_aware
    elif isinstance(plan, MeshAggExec):
        n.mesh_agg.producer.CopyFrom(physical_to_proto(plan.producer))
        for e in plan.group_exprs:
            n.mesh_agg.group_exprs.append(expr_to_proto(e))
        for e in plan.agg_exprs:
            n.mesh_agg.agg_exprs.append(expr_to_proto(e))
        for e in plan.hash_exprs:
            n.mesh_agg.hash_exprs.append(expr_to_proto(e))
        n.mesh_agg.n_devices = plan.n_devices
        n.mesh_agg.group_capacity = plan.group_capacity
    elif isinstance(plan, ops.SortExec):
        n.sort.input.CopyFrom(physical_to_proto(plan.child))
        for e in plan.sort_exprs:
            n.sort.sort_exprs.append(expr_to_proto(e))
    elif isinstance(plan, ops.LimitExec):
        n.limit.input.CopyFrom(physical_to_proto(plan.child))
        n.limit.n = plan.n
    elif isinstance(plan, ops.MergeExec):
        n.merge.input.CopyFrom(physical_to_proto(plan.child))
    elif isinstance(plan, ops.CoalesceBatchesExec):
        n.coalesce_batches.input.CopyFrom(physical_to_proto(plan.child))
    elif isinstance(plan, ops.RepartitionExec):
        n.repartition.input.CopyFrom(physical_to_proto(plan.child))
        n.repartition.num_partitions = plan.num_partitions
        for e in plan.hash_exprs or []:
            n.repartition.hash_exprs.append(expr_to_proto(e))
    elif isinstance(plan, ShuffleReaderExec):
        for loc in plan.partition_locations:
            n.shuffle_reader.partition_location.append(location_to_proto(loc))
        n.shuffle_reader.schema.CopyFrom(schema_to_proto(plan.output_schema()))
        for ranges in plan.read_partitions or []:
            rp = n.shuffle_reader.read_partitions.add()
            for olo, ohi, plo, phi in ranges:
                rp.ranges.add(output_lo=olo, output_hi=ohi,
                              producer_lo=plo, producer_hi=phi)
        n.shuffle_reader.hash_columns.extend(plan.hash_columns)
        n.shuffle_reader.original_partitions = plan.original_partitions
    elif isinstance(plan, UnresolvedShuffleExec):
        n.unresolved_shuffle.query_stage_ids.extend(plan.query_stage_ids)
        n.unresolved_shuffle.schema.CopyFrom(schema_to_proto(plan.output_schema()))
        n.unresolved_shuffle.partition_count = plan.partition_count
    elif isinstance(plan, ops.EmptyExec):
        n.empty.produce_one_row = plan.produce_one_row
    elif isinstance(plan, ExplainExec):
        n.explain.plan_type.extend(t for t, _ in plan.rows)
        n.explain.plan.extend(p for _, p in plan.rows)
    elif isinstance(plan, ExplainAnalyzeExec):
        n.explain_analyze.input.CopyFrom(physical_to_proto(plan.inner))
        n.explain_analyze.verbose = plan.verbose
        n.explain_analyze.logical_text = plan.logical_text or ""
    else:
        raise SerdeError(f"cannot serialize physical plan {type(plan).__name__}")
    return n


def physical_from_proto(n: pb.PhysicalPlanNode, *, device):
    """Plan node -> physical plan whose sources, readers and operators
    that make batches all live on ``device`` (required: the wire has no
    device)."""
    return _physical_from_proto(n, device)


def _physical_from_proto(n: pb.PhysicalPlanNode, device):
    from .physical.aggregate import HashAggregateExec
    from .physical.join import JoinExec
    from .physical import operators as ops
    from .physical.shuffle import ShuffleReaderExec, UnresolvedShuffleExec

    def physical_from_proto(m):  # threads the device through the recursion
        return _physical_from_proto(m, device)

    kind = n.WhichOneof("plan_type")
    if kind == "scan":
        src = source_from_proto(n.scan.source, device=device)
        proj = list(n.scan.projection) if n.scan.has_projection else None
        return ops.ScanExec(n.scan.table_name, src, proj)
    if kind == "projection":
        return ops.ProjectionExec(
            [expr_from_proto(e) for e in n.projection.exprs],
            physical_from_proto(n.projection.input),
        )
    if kind == "filter":
        return ops.FilterExec(
            expr_from_proto(n.filter.predicate),
            physical_from_proto(n.filter.input),
        )
    if kind == "hash_aggregate":
        return HashAggregateExec(
            n.hash_aggregate.mode,
            [expr_from_proto(e) for e in n.hash_aggregate.group_exprs],
            [expr_from_proto(e) for e in n.hash_aggregate.agg_exprs],
            physical_from_proto(n.hash_aggregate.input),
            n.hash_aggregate.group_capacity or 4096,
        )
    if kind == "join":
        return JoinExec(
            physical_from_proto(n.join.build),
            physical_from_proto(n.join.probe),
            [(o.left_col, o.right_col) for o in n.join.on],
            n.join.how,
            null_aware=n.join.null_aware,
            partitioned=n.join.partitioned,
            device=device,
            adaptive_note=n.join.adaptive_note or None,
        )
    if kind == "mesh_join":
        from .physical.mesh_agg import MeshJoinExec

        return MeshJoinExec(
            physical_from_proto(n.mesh_join.build_producer),
            physical_from_proto(n.mesh_join.probe_producer),
            [(o.left_col, o.right_col) for o in n.mesh_join.on],
            n.mesh_join.how,
            n.mesh_join.n_devices,
            null_aware=n.mesh_join.null_aware,
            device=device,
        )
    if kind == "mesh_agg":
        from .physical.aggregate import DEFAULT_GROUP_CAPACITY
        from .physical.mesh_agg import MeshAggExec

        return MeshAggExec(
            physical_from_proto(n.mesh_agg.producer),
            [expr_from_proto(e) for e in n.mesh_agg.group_exprs],
            [expr_from_proto(e) for e in n.mesh_agg.agg_exprs],
            [expr_from_proto(e) for e in n.mesh_agg.hash_exprs],
            n.mesh_agg.n_devices,
            n.mesh_agg.group_capacity or DEFAULT_GROUP_CAPACITY,
            device=device,
        )
    if kind == "sort":
        return ops.SortExec(
            [expr_from_proto(e) for e in n.sort.sort_exprs],
            physical_from_proto(n.sort.input),
        )
    if kind == "limit":
        return ops.LimitExec(n.limit.n, physical_from_proto(n.limit.input))
    if kind == "merge":
        return ops.MergeExec(physical_from_proto(n.merge.input))
    if kind == "coalesce_batches":
        return ops.CoalesceBatchesExec(
            physical_from_proto(n.coalesce_batches.input)
        )
    if kind == "repartition":
        hx = [expr_from_proto(e) for e in n.repartition.hash_exprs]
        return ops.RepartitionExec(
            physical_from_proto(n.repartition.input),
            n.repartition.num_partitions,
            hx or None,
        )
    if kind == "shuffle_reader":
        return ShuffleReaderExec(
            [location_from_proto(l) for l in n.shuffle_reader.partition_location],
            schema_from_proto(n.shuffle_reader.schema),
            read_partitions=[
                [(r.output_lo, r.output_hi, r.producer_lo, r.producer_hi)
                 for r in rp.ranges]
                for rp in n.shuffle_reader.read_partitions
            ] or None,
            hash_columns=tuple(n.shuffle_reader.hash_columns),
            original_partitions=n.shuffle_reader.original_partitions,
            device=device,
        )
    if kind == "unresolved_shuffle":
        return UnresolvedShuffleExec(
            list(n.unresolved_shuffle.query_stage_ids),
            schema_from_proto(n.unresolved_shuffle.schema),
            n.unresolved_shuffle.partition_count,
        )
    if kind == "empty":
        return ops.EmptyExec(device, n.empty.produce_one_row)
    if kind == "explain":
        from .physical.explain import ExplainExec

        return ExplainExec(list(zip(n.explain.plan_type, n.explain.plan)),
                           device)
    if kind == "explain_analyze":
        from .physical.explain import ExplainAnalyzeExec

        return ExplainAnalyzeExec(
            physical_from_proto(n.explain_analyze.input), device,
            n.explain_analyze.verbose,
            logical_text=n.explain_analyze.logical_text or None,
        )
    raise SerdeError(f"unknown physical node {kind}")


# ---------------------------------------------------------------------------
# Scheduling metadata helpers
# ---------------------------------------------------------------------------


def location_to_proto(loc) -> pb.PartitionLocation:
    """loc: distributed.types.PartitionLocation."""
    p = pb.PartitionLocation()
    p.partition_id.job_id = loc.job_id
    p.partition_id.stage_id = loc.stage_id
    p.partition_id.partition_id = loc.partition_id
    p.executor_meta.id = loc.executor_id
    p.executor_meta.host = loc.host
    p.executor_meta.port = loc.port
    p.path = loc.path or ""
    if loc.shuffle_output is not None:
        p.is_shuffle = True
        p.shuffle_output = loc.shuffle_output
    if loc.stats is not None:
        stats_to_proto(loc.stats, p.partition_stats)
    return p


def stats_to_proto(stats: dict, msg: "pb.PartitionStats") -> None:
    """PartitionStats dict (incl. optional per-column selectivity
    stats) -> proto."""
    msg.num_rows = stats.get("num_rows", 0)
    msg.num_batches = stats.get("num_batches", 0)
    msg.num_bytes = stats.get("num_bytes", 0)
    msg.shuffle_partition_bytes.extend(
        int(b) for b in stats.get("shuffle_partition_bytes") or []
    )
    for c in stats.get("columns") or []:
        cs = msg.column_stats.add()
        cs.name = c.get("name", "")
        cs.null_count = int(c.get("null_count", 0))
        cs.distinct_count = int(c.get("distinct_count", -1))
        for key, int_f, dbl_f, str_f in (
            ("min", "min_int", "min_double", "min_str"),
            ("max", "max_int", "max_double", "max_str"),
        ):
            v = c.get(key)
            if v is None:
                continue
            if isinstance(v, bool):
                setattr(cs, int_f, int(v))
            elif isinstance(v, int):
                setattr(cs, int_f, v)
            elif isinstance(v, float):
                setattr(cs, dbl_f, v)
            else:
                setattr(cs, str_f, str(v))


def stats_from_proto(msg: "pb.PartitionStats") -> dict:
    out = {
        "num_rows": msg.num_rows,
        "num_batches": msg.num_batches,
        "num_bytes": msg.num_bytes,
    }
    if msg.shuffle_partition_bytes:
        out["shuffle_partition_bytes"] = list(msg.shuffle_partition_bytes)
    cols = []
    for cs in msg.column_stats:
        c = {"name": cs.name, "null_count": cs.null_count,
             "distinct_count": cs.distinct_count}
        w = cs.WhichOneof("min_value")
        if w is not None:
            c["min"] = getattr(cs, w)
        w = cs.WhichOneof("max_value")
        if w is not None:
            c["max"] = getattr(cs, w)
        cols.append(c)
    if cols:
        out["columns"] = cols
    return out


def location_from_proto(p: pb.PartitionLocation):
    from .distributed.types import PartitionLocation

    return PartitionLocation(
        job_id=p.partition_id.job_id,
        stage_id=p.partition_id.stage_id,
        partition_id=p.partition_id.partition_id,
        executor_id=p.executor_meta.id,
        host=p.executor_meta.host,
        port=p.executor_meta.port,
        path=p.path,
        shuffle_output=p.shuffle_output if p.is_shuffle else None,
        stats=stats_from_proto(p.partition_stats),
    )


# ---------------------------------------------------------------------------
# Task/stage metrics (observability subsystem)
# ---------------------------------------------------------------------------
# Python shape: {"operators": [{"operator", "depth", "metrics": {...}}],
# "elapsed_total": float}. Timer values keep their ``elapsed_`` name
# prefix; the proto oneof preserves the kind across the wire.


def task_metrics_to_proto(tm: dict, msg: "pb.TaskMetrics") -> None:
    msg.elapsed_total_secs = float(tm.get("elapsed_total", 0.0))
    for row in tm.get("operators") or []:
        om = msg.operators.add()
        om.operator = row.get("operator", "")
        om.depth = int(row.get("depth", 0))
        for name, v in (row.get("metrics") or {}).items():
            mv = om.metrics.add()
            mv.name = name
            if name.startswith("elapsed_"):
                mv.elapsed_secs = float(v)
            elif isinstance(v, float):
                # Python type IS the kind: MetricsSet stores gauges as
                # float and counters as int, so an integral-valued gauge
                # (e.g. selectivity=1.0) must stay a gauge on the wire —
                # encoded as counter it would get SUMMED across tasks on
                # stage aggregation instead of max-ed
                mv.gauge = float(v)
            else:
                mv.counter = int(v)


def task_metrics_from_proto(msg: "pb.TaskMetrics") -> Optional[dict]:
    if not msg.operators and not msg.elapsed_total_secs:
        return None
    ops = []
    for om in msg.operators:
        metrics = {}
        for mv in om.metrics:
            which = mv.WhichOneof("value")
            if which == "elapsed_secs":
                metrics[mv.name] = mv.elapsed_secs
            elif which == "gauge":
                metrics[mv.name] = mv.gauge
            else:
                metrics[mv.name] = mv.counter
        ops.append({"operator": om.operator, "depth": om.depth,
                    "metrics": metrics})
    return {"operators": ops, "elapsed_total": msg.elapsed_total_secs}


def stage_metrics_to_proto(stages: Dict[int, dict], out) -> None:
    """stages: stage_id -> {"num_tasks", "elapsed_total", "operators"};
    ``out`` is a repeated StageMetrics field."""
    for sid in sorted(stages):
        st = stages[sid]
        sm = out.add()
        sm.stage_id = sid
        sm.num_tasks = int(st.get("num_tasks", 1))
        task_metrics_to_proto(st, sm.metrics)


def stage_metrics_from_proto(msgs) -> Dict[int, dict]:
    out: Dict[int, dict] = {}
    for sm in msgs:
        tm = task_metrics_from_proto(sm.metrics) or {
            "operators": [], "elapsed_total": 0.0}
        out[sm.stage_id] = {"num_tasks": sm.num_tasks or 1, **tm}
    return out


# -- distributed profiler: per-task profile windows ---------------------------
# Python shape (observability/distributed.capture_task_profile):
# {"t0", "wall_seconds", "pid", "role", "executor_id",
#  "records": [span dict...], "phases": {...}, "compile": {...},
#  "memory": {...}}. Records/context dicts are free-form span attrs, so
# they cross the wire as JSON blobs.


def task_profile_to_proto(p: dict, msg: "pb.TaskProfile") -> None:
    import json

    msg.t0 = float(p.get("t0", 0.0))
    msg.wall_seconds = float(p.get("wall_seconds", 0.0))
    msg.pid = int(p.get("pid", 0))
    msg.role = str(p.get("role", "executor"))
    msg.executor_id = str(p.get("executor_id", ""))
    # capture_task_profile pre-encodes the record list while applying
    # its byte bound — reuse that instead of serializing twice
    pre = p.get("records_json")
    msg.records_json = pre.encode() if isinstance(pre, str) else \
        json.dumps(p.get("records") or [], default=str).encode()
    msg.phases_json = json.dumps(p.get("phases") or {},
                                 default=str).encode()
    msg.compile_json = json.dumps(p.get("compile") or {},
                                  default=str).encode()
    msg.memory_json = json.dumps(p.get("memory") or {},
                                 default=str).encode()


def task_profile_from_proto(msg: "pb.TaskProfile") -> Optional[dict]:
    import json

    if not msg.records_json and not msg.wall_seconds:
        return None

    def _load(raw, default):
        try:
            return json.loads(raw.decode()) if raw else default
        except (ValueError, UnicodeDecodeError):
            return default

    return {
        "t0": msg.t0,
        "wall_seconds": msg.wall_seconds,
        "pid": msg.pid,
        "role": msg.role or "executor",
        "executor_id": msg.executor_id,
        "records": _load(msg.records_json, []),
        "phases": _load(msg.phases_json, {}),
        "compile": _load(msg.compile_json, {}),
        "memory": _load(msg.memory_json, {}),
    }


# -- live progress plane: job/stage progress snapshots ------------------------
# Python shape (observability/progress.py snapshot contract — ONE shape
# on both paths): {"job_id", "status", "fraction", "eta_seconds"
# (None = unknown), "wall_seconds", "tasks_total", "tasks_running",
# "tasks_queued", "tasks_completed", "stages": [{"stage_id",
# "tasks_total", "tasks_running", "tasks_completed", "fraction",
# "eta_seconds", "rows_so_far", "bytes_so_far"}, ...]}.


def job_progress_to_proto(snap: dict, msg: "pb.JobProgress") -> None:
    def _eta(v):
        return -1.0 if v is None else float(v)

    msg.fraction = float(snap.get("fraction", 0.0))
    msg.eta_seconds = _eta(snap.get("eta_seconds"))
    msg.wall_seconds = float(snap.get("wall_seconds", 0.0))
    msg.tasks_total = int(snap.get("tasks_total", 0))
    msg.tasks_running = int(snap.get("tasks_running", 0))
    msg.tasks_queued = int(snap.get("tasks_queued", 0))
    msg.tasks_completed = int(snap.get("tasks_completed", 0))
    for st in snap.get("stages") or []:
        sp = msg.stages.add()
        sp.stage_id = int(st.get("stage_id", 0))
        sp.tasks_total = int(st.get("tasks_total", 0))
        sp.tasks_running = int(st.get("tasks_running", 0))
        sp.tasks_completed = int(st.get("tasks_completed", 0))
        sp.fraction = float(st.get("fraction", 0.0))
        sp.eta_seconds = _eta(st.get("eta_seconds"))
        sp.rows_so_far = int(st.get("rows_so_far") or 0)
        sp.bytes_so_far = int(st.get("bytes_so_far") or 0)


def job_progress_from_proto(msg: "pb.JobProgress", job_id: str = "",
                            status: str = "running") -> dict:
    def _eta(v):
        return None if v < 0 else float(v)

    return {
        "job_id": job_id,
        "status": status,
        "fraction": msg.fraction,
        "eta_seconds": _eta(msg.eta_seconds),
        "wall_seconds": msg.wall_seconds,
        "tasks_total": msg.tasks_total,
        "tasks_running": msg.tasks_running,
        "tasks_queued": msg.tasks_queued,
        "tasks_completed": msg.tasks_completed,
        "stages": [
            {
                "stage_id": sp.stage_id,
                "tasks_total": sp.tasks_total,
                "tasks_running": sp.tasks_running,
                "tasks_completed": sp.tasks_completed,
                "fraction": sp.fraction,
                "eta_seconds": _eta(sp.eta_seconds),
                "rows_so_far": sp.rows_so_far,
                "bytes_so_far": sp.bytes_so_far,
            }
            for sp in msg.stages
        ],
    }
