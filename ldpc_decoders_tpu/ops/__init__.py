"""Batched primitive ops: edge-table graphs, segment reductions,
parity-polytope projection, and small math helpers."""

from ldpc_decoders_tpu.ops.graph import TannerGraph  # noqa: F401
