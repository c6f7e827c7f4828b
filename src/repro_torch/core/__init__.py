"""Core bitmap-index library, in-memory path: the paper's contribution.

EWAH word-aligned compression with hybrid containers, k-of-N encoding with
alphabetic (Algorithm 2) and Gray-code allocation, fact-table sorting
(lexicographic, Gray-code, random-sort grouping, block-wise, external
merge), index construction (Algorithm 3 semantics), the planner, and the
executor whose dense path runs the device kernel.
"""
from .bitpack import pack_bits, unpack_bits, pack_matrix
from .ewah import EWAH, binary_op, and_many, or_many
from .containers import (CHUNK_BITS, Containers, T_ARRAY, T_DENSE, T_EMPTY,
                         T_FULL, T_RUN)
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
from .expr import (And, Col, Const, Eq, Expr, In, Not, Or, Range,
                   canonical_key, col, from_wire, to_wire)
from .planner import explain, plan
from .executor import (Executor, QueryBatch, execute, execute_count,
                       execute_group_count, execute_rows)
from .dataset import Dataset, Query
from . import synth

__all__ = [
    "pack_bits", "unpack_bits", "pack_matrix",
    "EWAH", "binary_op", "and_many", "or_many",
    "Containers", "CHUNK_BITS",
    "T_EMPTY", "T_FULL", "T_ARRAY", "T_DENSE", "T_RUN",
    "ColumnEncoder", "bitmaps_needed", "choose_k", "unrank_lex", "revolving_door",
    "ADVISOR_VERSION", "LayoutDecision", "LayoutStats", "advise_order",
    "remap_from_counts", "validate_remap",
    "SortStats", "lex_sort", "gray_sort", "lex_sort_bits", "random_sort",
    "random_shuffle", "block_sort", "external_merge_sort_perm",
    "external_sorted_chunks", "order_columns", "order_columns_freq_aware",
    "BitmapIndex", "ColumnIndex", "IndexBuilder",
    "concat_bitmaps", "index_from_numpy", "validate_partition_rows",
    "Expr", "Col", "col", "Eq", "In", "Range", "And", "Or", "Not", "Const",
    "canonical_key", "from_wire", "to_wire",
    "plan", "explain", "Executor", "execute", "execute_rows",
    "execute_count", "execute_group_count", "QueryBatch",
    "Dataset", "Query",
    "synth",
]
