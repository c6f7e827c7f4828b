"""Core bitmap-index library: the paper's contribution.

EWAH word-aligned compression with hybrid containers, WAH baseline, k-of-N
encoding with alphabetic (Algorithm 2) and Gray-code allocation, fact-table
sorting (lexicographic, Gray-code, random-sort grouping, block-wise,
external merge), index construction (Algorithm 3 semantics), the planner,
the executor whose dense path runs the device kernel, the memory-mapped
index store, row shards, and live ingest over a write-ahead log.
"""
from .bitpack import pack_bits, unpack_bits, pack_matrix
from .ewah import EWAH, binary_op, and_many, or_many
from .containers import (CHUNK_BITS, Containers, T_ARRAY, T_DENSE, T_EMPTY,
                         T_FULL, T_RUN)
from .wah import WAH
from .encoding import ColumnEncoder, bitmaps_needed, choose_k, unrank_lex, revolving_door
from .layout import (ADVISOR_VERSION, LayoutDecision, LayoutStats,
                     advise_order, remap_from_counts, validate_remap)
from .sorting import (
    SortStats, lex_sort, gray_sort, lex_sort_bits, random_sort,
    random_shuffle, block_sort, external_merge_sort_perm,
    external_sorted_chunks, order_columns, order_columns_freq_aware,
)
from .index import (BitmapIndex, ColumnIndex, IndexBuilder, concat_bitmaps,
                    index_from_numpy, validate_partition_rows)
from .store import (StoreCorruptError, StoreError, StoreVersionError,
                    StoreWriter, load, load_sharded, manifest_meta, save,
                    save_sharded, write_shard_file)
from .expr import (And, Col, Const, Eq, Expr, In, Not, Or, Range,
                   canonical_key, col, from_wire, to_wire)
from .planner import explain, plan
from .executor import (Executor, QueryBatch, execute, execute_count,
                       execute_group_count, execute_rows)
from .shard import ForkSafetyError, ShardedIndex, ShardProcessPool
from .wal import WAL, WALError, replay as wal_replay
from .ingest import Compactor, DeltaIndex, LiveIndex
from .dataset import Dataset, Query
from . import query
from . import synth

__all__ = [
    "pack_bits", "unpack_bits", "pack_matrix",
    "EWAH", "binary_op", "and_many", "or_many", "WAH",
    "Containers", "CHUNK_BITS",
    "T_EMPTY", "T_FULL", "T_ARRAY", "T_DENSE", "T_RUN",
    "ColumnEncoder", "bitmaps_needed", "choose_k", "unrank_lex", "revolving_door",
    "ADVISOR_VERSION", "LayoutDecision", "LayoutStats", "advise_order",
    "remap_from_counts", "validate_remap",
    "SortStats", "lex_sort", "gray_sort", "lex_sort_bits", "random_sort",
    "random_shuffle", "block_sort", "external_merge_sort_perm",
    "external_sorted_chunks", "order_columns", "order_columns_freq_aware",
    "BitmapIndex", "ColumnIndex", "IndexBuilder", "ShardedIndex",
    "ShardProcessPool", "ForkSafetyError",
    "concat_bitmaps", "index_from_numpy", "validate_partition_rows",
    "StoreError", "StoreVersionError", "StoreCorruptError", "StoreWriter",
    "save", "load", "save_sharded", "load_sharded", "write_shard_file",
    "manifest_meta",
    "Expr", "Col", "col", "Eq", "In", "Range", "And", "Or", "Not", "Const",
    "canonical_key", "from_wire", "to_wire",
    "plan", "explain", "Executor", "execute", "execute_rows",
    "execute_count", "execute_group_count", "QueryBatch",
    "WAL", "WALError", "wal_replay",
    "LiveIndex", "DeltaIndex", "Compactor",
    "Dataset", "Query",
    "query", "synth",
]
