"""Hash join execution.

Reference: velox/exec/HashBuild.h:39 / HashProbe.h:28 / HashJoinBridge.h — the
reference builds a quadratic-probing hash table from the build side and streams
probe batches through it.

Device re-design: random-access probing (hash probes, binary search) was
orders of magnitude slower than a multi-operand sort on the engine's first
target (not measured on a GPU).  The probe is therefore a **sort-merge
lookup**:

  1. build side: key-sorted arrays, device-resident (the JoinBridge analog);
  2. per probe tile: sort the concatenation [build keys ++ probe keys] with a
     tie-break flag so each build row precedes equal probe keys;
  3. a running maximum (cummax) of "last build row index seen" gives every probe
     row its candidate match in one scan;
  4. a second sort by original position restores probe order ("scatter = sort").

Everything is sort/scan/gather — no scatters, no binary search.  This is the
normalized-key regime the reference itself prefers (HashTable kNormalizedKey,
velox/exec/HashTable.h:74): multi-column keys are packed into one int64
normalized key from build-side value ranges (VectorHasher range mode,
velox/exec/VectorHasher.h:118); probe values outside any range cannot match and
map to a negative sentinel.

Scope: equi-joins.  A UNIQUE build side (primary-key joins) probes in one fused
program.  A build side with DUPLICATE keys becomes an **expansion join**: the
build keeps per-key runs (start, count) in sorted order, each probe row
resolves to a span over the build array, and the output is produced by the
same scatter-free span-expansion machinery as Unnest (ops/segpool) into a
power-of-two output bucket sized by one per-tile scalar fetch.  LEFT_SEMI and
ANTI deduplicate the build keys, so any build side works there.  Non-equi join
filters lower to FilterNode above an INNER join (semantically identical; the
reference fuses them in HashProbe instead); on LEFT they null-out failing
matches, and on LEFT_SEMI/ANTI they lower through
rewrite_filtered_existence_joins (bottom of this file).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import RowType
from ..io.table import Table
from ..plan.nodes import HashJoinNode, JoinType
from ..vector.column import Batch, Column


class JoinBuildError(RuntimeError):
    pass


class DuplicateBuildKeys(JoinBuildError):
    """Signals the device-resident build path that the build side needs
    expansion-join state; the caller falls back to the host build."""


@dataclasses.dataclass
class _NormalizedKey:
    """Pack k build-key columns into one int64 (VectorHasher range mode).

    Composite keys wider than 62 bits split into TWO int64 limbs (``split``
    marks the first low-limb field) — the analog of the reference's
    kNormalizedKey -> kHash degradation (HashTable.cpp decideHashMode),
    except exactness is kept by comparing both limbs instead of hashing.
    """

    mins: np.ndarray  # [k] int64 per-key build-side minimum
    maxs: np.ndarray  # [k] int64 per-key build-side maximum
    shifts: np.ndarray  # [k] left-shift per key (within its limb)
    split: int = 0  # fields [0, split) ride the HIGH limb; 0 = single-limb

    @property
    def two_limb(self) -> bool:
        return self.split > 0

    @staticmethod
    def fit(key_arrays: Sequence[np.ndarray]) -> "_NormalizedKey":
        return _NormalizedKey.fit_from_bounds(
            [int(a.min()) if len(a) else 0 for a in key_arrays],
            [int(a.max()) if len(a) else 0 for a in key_arrays],
        )

    @staticmethod
    def fit_from_bounds(los, his) -> "_NormalizedKey":
        mins, maxs, bits = [], [], []
        for lo, hi in zip(los, his):
            lo, hi = int(lo), max(int(lo), int(hi))
            mins.append(lo)
            maxs.append(hi)
            bits.append(max(1, int(hi - lo).bit_length()))
        split = 0
        if sum(bits) > 62 and len(bits) > 1:
            # greedy: fill the high limb until the rest fits the low limb.
            # A single field wider than 62 bits may occupy a limb ALONE:
            # (v - min) then wraps int64, which is a bijection — equality
            # and probe/build consistency are preserved (the lookup needs a
            # consistent total order, not the natural one).
            acc = 0
            for i, b in enumerate(bits):
                if acc == 0 and b > 62:
                    split = i + 1  # oversized field takes the limb alone
                    break
                if acc + b > 62:
                    split = i
                    break
                acc += b
            else:
                split = len(bits)
            lo_bits = bits[split:]
            if split == 0 or (len(lo_bits) > 1 and sum(lo_bits) > 62):
                raise JoinBuildError(
                    f"multi-key join key ranges need {sum(bits)} bits across "
                    f"{len(bits)} keys; they do not fit two int64 limbs "
                    "(reorder the keys, pre-aggregate, or split the join)"
                )
        shifts = np.zeros(len(bits), dtype=np.int64)
        for limb_fields in ((range(0, split) if split else []),
                            range(split, len(bits))):
            acc = 0
            idxs = list(limb_fields)
            for i in reversed(idxs):
                shifts[i] = acc
                acc += bits[i]
        return _NormalizedKey(
            np.asarray(mins, dtype=np.int64),
            np.asarray(maxs, dtype=np.int64),
            shifts,
            split,
        )

    def pack_host(self, key_arrays: Sequence[np.ndarray]) -> np.ndarray:
        """Single-limb packed keys (callers check ``two_limb`` first)."""
        assert not self.two_limb
        out = np.zeros(len(key_arrays[0]), dtype=np.int64)
        for arr, lo, sh in zip(key_arrays, self.mins, self.shifts):
            out += (arr.astype(np.int64) - lo) << sh
        return out

    def pack_host_limbs(self, key_arrays: Sequence[np.ndarray]):
        """(hi|None, lo) packed host keys."""
        if not self.two_limb:
            return None, self.pack_host(key_arrays)
        n = len(key_arrays[0])
        hi = np.zeros(n, dtype=np.int64)
        lo_arr = np.zeros(n, dtype=np.int64)
        for i, (arr, mn, sh) in enumerate(
            zip(key_arrays, self.mins, self.shifts)
        ):
            term = (arr.astype(np.int64) - mn) << sh
            if i < self.split:
                hi += term
            else:
                lo_arr += term
        return hi, lo_arr

    def pack_device(
        self, key_values: Sequence[jax.Array], valid: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        """Returns (packed [cap] int64, in_range&valid [cap] bool); out-of-range
        probe values cannot match any build row and pack to -1."""
        assert not self.two_limb
        packed = jnp.zeros_like(key_values[0], dtype=jnp.int64)
        ok = valid
        for v, lo, hi, sh in zip(key_values, self.mins, self.maxs, self.shifts):
            v64 = v.astype(jnp.int64)
            ok = ok & (v64 >= int(lo)) & (v64 <= int(hi))
            packed = packed + ((v64 - int(lo)) << int(sh))
        return jnp.where(ok, packed, jnp.int64(-1)), ok

    def pack_device_limbs(
        self, key_values: Sequence[jax.Array], valid: jax.Array
    ):
        """((hi|None, lo), in_range&valid); two-limb analog of pack_device."""
        if not self.two_limb:
            packed, ok = self.pack_device(key_values, valid)
            return (None, packed), ok
        hi = jnp.zeros_like(key_values[0], dtype=jnp.int64)
        lo_arr = jnp.zeros_like(key_values[0], dtype=jnp.int64)
        ok = valid
        for i, (v, mn, mx, sh) in enumerate(
            zip(key_values, self.mins, self.maxs, self.shifts)
        ):
            v64 = v.astype(jnp.int64)
            ok = ok & (v64 >= int(mn)) & (v64 <= int(mx))
            term = (v64 - int(mn)) << int(sh)
            if i < self.split:
                hi = hi + term
            else:
                lo_arr = lo_arr + term
        return (
            jnp.where(ok, hi, jnp.int64(-1)),
            jnp.where(ok, lo_arr, jnp.int64(-1)),
        ), ok


_KEY_SENTINEL = np.iinfo(np.int64).max


def _index_bits(n: int) -> int:
    return max(1, int(n - 1).bit_length()) if n > 1 else 1


def _key_codes(keys: jax.Array, lo: int, span: int) -> jax.Array:
    """Order- and equality-preserving map of keys into [0, span]: valid build
    keys in [lo, hi] land on [1, span-1]; anything below-range lands on 0 and
    anything above-range (incl. the int64-max sentinel) on span.  Out-of-range
    collisions are harmless — the match test compares the RAW keys.  Clip
    BEFORE subtracting: ``sentinel - (lo-1)`` would wrap around int64."""
    lo1 = jnp.int64(lo - 1)
    return jnp.clip(keys, lo1, jnp.int64(lo - 1 + span)) - lo1


@dataclasses.dataclass
class HashJoinExec:
    """Device-resident build state + trace-time probe application."""

    node: HashJoinNode
    build_keys: jax.Array  # [B] sorted normalized keys (invalid tail: sentinel)
    # two-limb composite keys (>62 bits): the HIGH limb rides here and every
    # key comparison tests both limbs; None for single-limb keys
    build_keys_hi: Optional[jax.Array] = dataclasses.field(
        default=None, kw_only=True
    )
    build_cols: Dict[str, Tuple[jax.Array, Optional[jax.Array]]]  # sorted payloads
    build_size: int
    build_tables: Dict[str, object]
    normalizer: Optional[_NormalizedKey]  # None for single raw int64 key
    build_valid: Optional[jax.Array] = None  # [B] live-slot mask (device builds)
    # expansion (N:M) join state: per sorted-build-slot run info
    expansion: bool = False
    run_start: Optional[jax.Array] = None  # [B] first slot of this key's run
    run_count: Optional[jax.Array] = None  # [B] length of this key's run
    # host-known (min, max) of the VALID build keys: enables the packed
    # single-operand probe sorts (_pack_probe_sort below); None = unknown
    key_range: Optional[Tuple[int, int]] = None
    # null-aware ANTI state (reference: HashJoinNode nullAware): whether any
    # live build row carried a NULL key, and how many valid-key build rows
    # exist (an EMPTY build set means NOT IN () = true for every probe row,
    # null keys included)
    build_has_null_key: bool = dataclasses.field(default=False, kw_only=True)
    n_valid_build_keys: int = dataclasses.field(default=0, kw_only=True)
    # The fused probe emits in MERGED order with capacity B + cap; callers
    # whose downstream shapes are sized to the probe batch's capacity (the
    # distributed per-device pipelines) disable it and keep the
    # capacity-preserving classification path.
    allow_fused: bool = dataclasses.field(default=True, kw_only=True)
    # Fused-probe build payload (see _probe_fused): every build output column
    # bit-packed into ONE int64 per build row, so the merge sort's cummax
    # propagates the whole payload to matching probe rows with ZERO gathers.
    bp_plan: Optional[object] = dataclasses.field(default=None, kw_only=True)
    bp_packed: Optional[jax.Array] = dataclasses.field(
        default=None, kw_only=True
    )
    bp_fields: Optional[Tuple] = dataclasses.field(default=None, kw_only=True)
    # split-dispatch probe state (probe_split_host): cached (pre, post) jits
    # and the operand layout recorded at pre-trace time for the post trace
    _split_jits: Optional[Tuple] = dataclasses.field(
        default=None, kw_only=True, repr=False, compare=False
    )
    _split_meta: Optional[Tuple] = dataclasses.field(
        default=None, kw_only=True, repr=False, compare=False
    )

    def _prepare_build_payload(self, bounds_map) -> None:
        """Pack the build's non-key output columns (+ validity bits) into one
        int64 word per row when their combined bit-width allows — the fused
        probe then carries the payload through its cummax scan instead of
        gathering per column (bits already in the scanned word cost nothing
        more to move; a random gather per column does).

        ``bounds_map``: per-column inclusive (lo, hi) integer bounds.  Any
        non-integer or unbounded column disables packing (tier-2 fallback:
        per-column gathers by candidate index)."""
        from ..ops.sortkey import PackPlan

        if not self.build_cols:
            return
        fields: List[Tuple[str, str]] = []  # ('v'|'n', column name)
        bounds: List[Tuple[int, int]] = []
        for name, (values, validity) in self.build_cols.items():
            if not (
                jnp.issubdtype(values.dtype, jnp.integer)
                or values.dtype == jnp.bool_
            ):
                return
            b = bounds_map.get(name)
            if b is None:
                return
            fields.append(("v", name))
            bounds.append((int(b[0]), int(b[1])))
            if validity is not None:
                fields.append(("n", name))
                bounds.append((0, 1))
        plan = PackPlan.fit(bounds)
        if plan is None:
            return
        vals = []
        for (kind, name), (lo, hi) in zip(fields, bounds):
            values, validity = self.build_cols[name]
            if kind == "v":
                # clamp into bounds: padding slots / garbage-under-null must
                # not overflow into neighboring fields (they never match)
                v = jnp.clip(
                    values.astype(jnp.int64), jnp.int64(lo), jnp.int64(hi)
                )
                vals.append(v)
            else:
                vals.append(validity.astype(jnp.int64))
        self.bp_packed = plan.pack(vals)
        self.bp_plan = plan
        self.bp_fields = tuple(fields)

    @staticmethod
    def build(node: HashJoinNode, build_result: Table) -> "HashJoinExec":
        """Construct the bridge from the executed build-side pipeline result."""
        if node.filter is not None and node.join_type not in (
            JoinType.INNER, JoinType.LEFT
        ):
            # INNER/LEFT filters are stripped by _linearize; semi/anti/full
            # lower through the plan rewrites — reaching here means a
            # lowering was skipped, and silently dropping the filter would
            # return wrong rows
            raise NotImplementedError(
                f"join filter on {node.join_type} must be lowered before "
                "execution (rewrite_filtered_existence_joins)"
            )
        key_names = list(node.right_keys)
        key_arrays = [np.asarray(build_result.columns[k]) for k in key_names]

        # Build rows with a NULL key can never match (standard, non-null-aware
        # join semantics; reference HashBuild drops them too for inner/semi
        # joins).  For FULL they must survive as definitionally-unmatched rows,
        # so they keep a sentinel key that sorts last and equals nothing.
        keep = None
        for k in key_names:
            validity = build_result.validities.get(k)
            if validity is not None and not validity.all():
                keep = validity if keep is None else (keep & validity)
        full = node.join_type == JoinType.FULL
        if keep is not None and not full:
            key_arrays = [a[keep] for a in key_arrays]

        if len(key_names) == 1:
            normalizer = None
            packed_hi, packed = None, key_arrays[0].astype(np.int64)
        else:
            fit_arrays = (
                [a[keep] for a in key_arrays] if (keep is not None) else key_arrays
            )
            normalizer = _NormalizedKey.fit(fit_arrays)
            packed_hi, packed = normalizer.pack_host_limbs(key_arrays)
        if keep is not None and full:
            packed = packed.copy()
            packed[~keep] = _KEY_SENTINEL
            if packed_hi is not None:
                packed_hi = packed_hi.copy()
                packed_hi[~keep] = _KEY_SENTINEL

        if packed_hi is None:
            order = np.argsort(packed, kind="stable")
        else:
            order = np.lexsort((packed, packed_hi))
        if keep is not None and not full:
            row_order = np.flatnonzero(keep)[order]
        else:
            row_order = order
        keys_sorted = packed[order]
        keys_hi_sorted = None if packed_hi is None else packed_hi[order]

        def _dups(lo, hi):
            if len(lo) <= 1:
                return np.zeros(0, dtype=bool)
            eq = lo[1:] == lo[:-1]
            if hi is not None:
                eq = eq & (hi[1:] == hi[:-1])
            return eq

        jt = node.join_type
        expansion = False
        run_start = run_count = None
        if jt in (JoinType.LEFT_SEMI, JoinType.ANTI):
            # Only existence matters; deduplicate so any build side works.
            eq = _dups(keys_sorted, keys_hi_sorted)
            first = np.concatenate([[True], ~eq]) if len(keys_sorted) else np.zeros(0, bool)
            keys_sorted = keys_sorted[first]
            if keys_hi_sorted is not None:
                keys_hi_sorted = keys_hi_sorted[first]
            row_order = row_order[first]
        elif jt == JoinType.FULL or _dups(keys_sorted, keys_hi_sorted).any():
            # duplicate keys (or FULL, which always needs the expansion
            # machinery for its unmatched-build epilogue): keep per-key runs
            if keys_hi_sorted is not None:
                raise JoinBuildError(
                    "N:M / FULL joins with composite keys wider than 62 bits "
                    "are not supported; pre-aggregate the build side"
                )
            expansion = True
            n = len(keys_sorted)
            boundary = np.ones(n, dtype=bool)
            if n:
                boundary[1:] = keys_sorted[1:] != keys_sorted[:-1]
            starts = np.flatnonzero(boundary)
            lengths = np.diff(np.append(starts, n))
            run_start = jnp.asarray(
                np.repeat(starts, lengths).astype(np.int32)
            )
            run_count = jnp.asarray(
                np.repeat(lengths, lengths).astype(np.int32)
            )

        cols: Dict[str, Tuple[jax.Array, Optional[jax.Array]]] = {}
        bounds_map: Dict[str, Tuple[int, int]] = {}
        right_schema = node.right.output_schema
        for name in node.output_columns:
            # FULL keeps the right KEY columns too: the unmatched-build
            # epilogue must emit real key values, not probe-side copies
            if name in right_schema and (
                name not in key_names or jt == JoinType.FULL
            ):
                arr = np.asarray(build_result.columns[name])[row_order]
                validity = build_result.validities.get(name)
                if (
                    len(arr)
                    and (
                        np.issubdtype(arr.dtype, np.integer)
                        or arr.dtype == np.bool_
                    )
                ):
                    src = arr if validity is None else arr[validity[row_order]]
                    if len(src):
                        bounds_map[name] = (int(src.min()), int(src.max()))
                v = None if validity is None else jnp.asarray(validity[row_order])
                cols[name] = (jnp.asarray(arr), v)
        # (min, max) over the valid keys — keys are sorted ascending with the
        # int64-max sentinels (FULL null-key rows) last.  Two-limb keys get no
        # range: the packed single-operand fast path only covers one limb.
        n_valid_keys = len(keys_sorted) - int(
            np.sum(keys_sorted == _KEY_SENTINEL)
        )
        key_range = (
            (int(keys_sorted[0]), int(keys_sorted[n_valid_keys - 1]))
            if n_valid_keys and keys_hi_sorted is None
            else None
        )
        exec_ = HashJoinExec(
            node,
            jnp.asarray(keys_sorted),
            cols,
            len(keys_sorted),
            dict(build_result.string_tables),
            normalizer,
            expansion=expansion,
            run_start=run_start,
            run_count=run_count,
            key_range=key_range,
            build_keys_hi=(
                None if keys_hi_sorted is None else jnp.asarray(keys_hi_sorted)
            ),
            build_has_null_key=keep is not None,
            n_valid_build_keys=n_valid_keys,
        )
        if not expansion:
            exec_._prepare_build_payload(bounds_map)
        return exec_

    @staticmethod
    def build_from_device(
        node: HashJoinNode, batches, err_scalar, split_sorts: bool = True
    ) -> "HashJoinExec":
        """Construct the bridge from device-resident compacted tile batches —
        the build data never round-trips to the host; only a handful of scalars
        (row count, duplicate count, key ranges) are fetched.

        This matters because the device can sit behind a slow host link: the
        reference's HashBuild keeps build rows in host RAM (RowContainer),
        while here they stay in HBM end to end.
        """
        from ..utils.transfer import _prefix_slicer, bucket_of, fetch_tree

        right_schema = node.right.output_schema
        key_names = list(node.right_keys)
        jt = node.join_type
        semi = jt in (JoinType.LEFT_SEMI, JoinType.ANTI)
        col_names = [
            n for n in node.output_columns
            if n in right_schema and n not in key_names
        ] if not semi else []
        strings: Dict[str, object] = {}
        for b in batches:
            for name, col in zip(b.schema.names, b.columns):
                if col.strings is not None:
                    strings[name] = col.strings

        def _concat_col(bs, name):
            datas, valids = [], []
            any_valid = False
            for b in bs:
                v, val = b.column(name).decode(b.capacity)
                datas.append(v)
                valids.append(val)
                any_valid = any_valid or val is not None
            data = jnp.concatenate(datas) if len(datas) > 1 else datas[0]
            validity = None
            if any_valid:
                validity = jnp.concatenate(
                    [
                        v if v is not None else jnp.ones((b.capacity,), jnp.bool_)
                        for v, b in zip(valids, bs)
                    ]
                ) if len(valids) > 1 else valids[0]
            return data, validity

        @jax.jit
        def key_stats(bs):
            mask = jnp.concatenate([b.active_mask() for b in bs])
            kvalid = mask
            keys = []
            for k in key_names:
                d, val = _concat_col(bs, k)
                keys.append(d.astype(jnp.int64))
                if val is not None:
                    kvalid = kvalid & val
            big = jnp.int64(1) << 62
            mins = jnp.stack([jnp.min(jnp.where(kvalid, k, big)) for k in keys])
            maxs = jnp.stack([jnp.max(jnp.where(kvalid, k, -big)) for k in keys])
            return mins, maxs

        if len(key_names) > 1:
            mins, maxs = fetch_tree(key_stats(batches))  # tiny round trip
            normalizer = _NormalizedKey.fit_from_bounds(mins, maxs)
        else:
            normalizer = None

        @jax.jit
        def prepare(bs, err):
            if isinstance(err, (tuple, list)):
                # per-tile error scalars from run_device, summed here so the
                # producer never compiles a standalone add program
                total = jnp.zeros((), dtype=jnp.int64)
                for e in err:
                    total = total + e
                err = total
            mask = jnp.concatenate([b.active_mask() for b in bs])
            kvalid = mask
            keys = []
            for k in key_names:
                d, val = _concat_col(bs, k)
                keys.append(d.astype(jnp.int64))
                if val is not None:
                    kvalid = kvalid & val
            if normalizer is None:
                packed_hi, packed = None, keys[0]
            else:
                (packed_hi, packed), _ = normalizer.pack_device_limbs(
                    keys, kvalid
                )
            packed = jnp.where(kvalid, packed, jnp.int64(_KEY_SENTINEL))
            n = packed.shape[0]
            orig = jnp.arange(n, dtype=jnp.int32)
            if packed_hi is None:
                s_inv, s_key, s_orig = jax.lax.sort(
                    (~kvalid, packed, orig), num_keys=2
                )
                s_hi = None
            else:
                packed_hi = jnp.where(
                    kvalid, packed_hi, jnp.int64(_KEY_SENTINEL)
                )
                s_inv, s_hi, s_key, s_orig = jax.lax.sort(
                    (~kvalid, packed_hi, packed, orig), num_keys=3
                )
            s_valid = ~s_inv
            pos = jnp.arange(n, dtype=jnp.int32)
            prev_eq = (
                (pos > 0)
                & s_valid
                & jnp.roll(s_valid, 1)
                & (s_key == jnp.roll(s_key, 1))
            )
            if s_hi is not None:
                prev_eq = prev_eq & (s_hi == jnp.roll(s_hi, 1))
            big = jnp.int64(1) << 62
            kmin = jnp.min(jnp.where(s_valid, s_key, big))
            kmax = jnp.max(jnp.where(s_valid, s_key, -big))
            if semi:
                keep = s_valid & ~prev_eq
                u_key = jnp.where(keep, s_key, jnp.int64(_KEY_SENTINEL))
                if s_hi is None:
                    u_sorted = jnp.sort(u_key)
                    u_hi = None
                else:
                    u_hi0 = jnp.where(keep, s_hi, jnp.int64(_KEY_SENTINEL))
                    u_hi, u_sorted = jax.lax.sort((u_hi0, u_key), num_keys=2)
                n_valid = jnp.sum(keep.astype(jnp.int32))
                return (
                    u_sorted, u_hi, {}, n_valid, jnp.zeros((), jnp.int32),
                    err, kmin, kmax, jnp.sum(mask.astype(jnp.int32)),
                    jnp.zeros((0,), jnp.int64),
                )
            n_valid = jnp.sum(s_valid.astype(jnp.int32))
            dup = jnp.sum(prev_eq.astype(jnp.int32))
            cols = {}
            for name in col_names:
                data, validity = _concat_col(bs, name)
                g = jnp.take(data, s_orig, mode="clip")
                gv = (
                    None
                    if validity is None
                    else jnp.take(validity, s_orig, mode="clip")
                )
                cols[name] = (g, gv)
            # per-integer-column (min, max) over live rows, computed INSIDE
            # this program: feeds the fused probe's packed payload without a
            # separate col_stats compile + fetch
            col_stats = []
            for nm in col_names:
                g, gv = cols[nm]
                if not (
                    jnp.issubdtype(g.dtype, jnp.integer)
                    or g.dtype == jnp.bool_
                ):
                    continue
                m = s_valid if gv is None else (s_valid & gv)
                v = g.astype(jnp.int64)
                col_stats.append(jnp.min(jnp.where(m, v, big)))
                col_stats.append(jnp.max(jnp.where(m, v, -big)))
            stats_vec = (
                jnp.stack(col_stats)
                if col_stats
                else jnp.zeros((0,), jnp.int64)
            )
            return (
                s_key, s_hi, cols, n_valid, dup, err, kmin, kmax,
                jnp.sum(mask.astype(jnp.int32)), stats_vec,
            )

        if split_sorts and not semi:
            # split-dispatch build: the build sort runs as the canonical
            # shared program (ops/shared_sort.py) between two glue programs,
            # keeping this BUILD's compiled programs sort-free (a premise
            # from the engine's first target, whose compiler charged tens of
            # seconds per sort-containing program; config.split_sort_programs)
            from ..ops.shared_sort import shared_sort_ops

            @jax.jit
            def prepare_pre(bs, err):
                if isinstance(err, (tuple, list)):
                    total = jnp.zeros((), dtype=jnp.int64)
                    for e in err:
                        total = total + e
                    err = total
                mask = jnp.concatenate([b.active_mask() for b in bs])
                kvalid = mask
                keys = []
                for k in key_names:
                    d, val = _concat_col(bs, k)
                    keys.append(d.astype(jnp.int64))
                    if val is not None:
                        kvalid = kvalid & val
                if normalizer is None:
                    packed_hi, packed = None, keys[0]
                else:
                    (packed_hi, packed), _ = normalizer.pack_device_limbs(
                        keys, kvalid
                    )
                packed = jnp.where(kvalid, packed, jnp.int64(_KEY_SENTINEL))
                n = packed.shape[0]
                orig = jnp.arange(n, dtype=jnp.int32)
                hi_t = ()
                if packed_hi is not None:
                    hi_t = (
                        jnp.where(
                            kvalid, packed_hi, jnp.int64(_KEY_SENTINEL)
                        ),
                    )
                return ~kvalid, hi_t, packed, orig, err, mask

            @jax.jit
            def prepare_post(bs, s_inv, s_hi_t, s_key, s_orig, err, mask):
                s_hi = s_hi_t[0] if s_hi_t else None
                s_valid = ~s_inv
                n = s_key.shape[0]
                pos = jnp.arange(n, dtype=jnp.int32)
                prev_eq = (
                    (pos > 0)
                    & s_valid
                    & jnp.roll(s_valid, 1)
                    & (s_key == jnp.roll(s_key, 1))
                )
                if s_hi is not None:
                    prev_eq = prev_eq & (s_hi == jnp.roll(s_hi, 1))
                big = jnp.int64(1) << 62
                kmin = jnp.min(jnp.where(s_valid, s_key, big))
                kmax = jnp.max(jnp.where(s_valid, s_key, -big))
                n_valid = jnp.sum(s_valid.astype(jnp.int32))
                dup = jnp.sum(prev_eq.astype(jnp.int32))
                cols = {}
                for name in col_names:
                    data, validity = _concat_col(bs, name)
                    g = jnp.take(data, s_orig, mode="clip")
                    gv = (
                        None
                        if validity is None
                        else jnp.take(validity, s_orig, mode="clip")
                    )
                    cols[name] = (g, gv)
                col_stats = []
                for nm in col_names:
                    g, gv = cols[nm]
                    if not (
                        jnp.issubdtype(g.dtype, jnp.integer)
                        or g.dtype == jnp.bool_
                    ):
                        continue
                    m = s_valid if gv is None else (s_valid & gv)
                    v = g.astype(jnp.int64)
                    col_stats.append(jnp.min(jnp.where(m, v, big)))
                    col_stats.append(jnp.max(jnp.where(m, v, -big)))
                stats_vec = (
                    jnp.stack(col_stats)
                    if col_stats
                    else jnp.zeros((0,), jnp.int64)
                )
                return (
                    s_key, s_hi, cols, n_valid, dup, err, kmin, kmax,
                    jnp.sum(mask.astype(jnp.int32)), stats_vec,
                )

            inv, hi_t, packed, orig, err_pre, mask_pre = prepare_pre(
                batches, err_scalar
            )
            key_ops = [inv] + list(hi_t) + [packed]
            s_keys, s_pays = shared_sort_ops(key_ops, [orig])
            s_inv_a = s_keys[0].astype(jnp.bool_)
            s_hi_tuple = tuple(s_keys[1:-1])
            (
                s_key, s_hi, cols, n_valid_d, dup_d, err_d, kmin_d, kmax_d,
                n_live_d, stats_d,
            ) = prepare_post(
                batches, s_inv_a, s_hi_tuple, s_keys[-1], s_pays[0],
                err_pre, mask_pre,
            )
        else:
            (
                s_key, s_hi, cols, n_valid_d, dup_d, err_d, kmin_d, kmax_d,
                n_live_d, stats_d,
            ) = prepare(batches, err_scalar)
        n_valid, dup, err, kmin, kmax, n_live, stats = fetch_tree(
            (n_valid_d, dup_d, err_d, kmin_d, kmax_d, n_live_d, stats_d)
        )  # round trip
        if int(err):
            from .runner import _raise_on_errors

            _raise_on_errors(int(err))
        if int(dup):
            raise DuplicateBuildKeys(
                "build side has duplicate keys; expansion state is built on "
                "the host path"
            )
        n = int(n_valid)
        # MUST enumerate in col_names order: prepare's stats_vec was built in
        # that order, while a dict returned through jax.jit comes back with
        # SORTED keys (pytree canonicalization)
        int_cols = [
            nm
            for nm in col_names
            if nm in cols
            and (
                jnp.issubdtype(cols[nm][0].dtype, jnp.integer)
                or cols[nm][0].dtype == jnp.bool_
            )
        ]
        st = np.asarray(stats)
        bounds_map = {
            nm: (int(st[2 * i]), int(st[2 * i + 1]))
            for i, nm in enumerate(int_cols)
            if n and st[2 * i] <= st[2 * i + 1]
        }
        bucket = min(bucket_of(max(n, 1)), s_key.shape[0])
        # build the payload-pack plan at trace time so the cut, the sentinel
        # masking, AND the bit-pack all land in ONE compiled program (each
        # extra program is one more compile)
        pack_plan = pack_fields = pack_bounds = None
        if bounds_map and not semi and len(bounds_map) == len(cols):
            from ..ops.sortkey import PackPlan

            fields, bounds = [], []
            for name, (g, gv) in cols.items():
                fields.append(("v", name))
                bounds.append(bounds_map[name])
                if gv is not None:
                    fields.append(("n", name))
                    bounds.append((0, 1))
            plan = PackPlan.fit(bounds)
            if plan is not None:
                pack_plan = plan
                pack_fields = tuple(fields)
                pack_bounds = tuple(bounds)

        @jax.jit
        def finalize(s_key, s_hi, cols):
            valid = jnp.arange(bucket, dtype=jnp.int32) < n
            keys_cut = jnp.where(
                valid, s_key[:bucket], jnp.int64(_KEY_SENTINEL)
            )
            keys_hi_cut = (
                None
                if s_hi is None
                else jnp.where(valid, s_hi[:bucket], jnp.int64(_KEY_SENTINEL))
            )
            out_cols = {
                name: (g[:bucket], None if gv is None else gv[:bucket])
                for name, (g, gv) in cols.items()
            }
            packed = None
            if pack_plan is not None:
                vals = []
                for (kind, name), (lo, hi) in zip(pack_fields, pack_bounds):
                    g, gv = out_cols[name]
                    if kind == "v":
                        # clamp: padding/garbage-under-null must not overflow
                        # into neighboring fields (they never match)
                        vals.append(
                            jnp.clip(
                                g.astype(jnp.int64),
                                jnp.int64(lo),
                                jnp.int64(hi),
                            )
                        )
                    else:
                        vals.append(gv.astype(jnp.int64))
                packed = pack_plan.pack(vals)
            return keys_cut, keys_hi_cut, out_cols, valid, packed

        keys_cut, keys_hi_cut, out_cols, valid, bp_packed = finalize(
            s_key, s_hi, cols
        )
        exec_ = HashJoinExec(
            node, keys_cut, out_cols, bucket, strings, normalizer, valid,
            key_range=(
                (int(kmin), int(kmax)) if n and keys_hi_cut is None else None
            ),
            build_keys_hi=keys_hi_cut,
            build_has_null_key=int(n_live) > int(n_valid),
            n_valid_build_keys=n,
        )
        if bp_packed is not None:
            exec_.bp_packed = bp_packed
            exec_.bp_plan = pack_plan
            exec_.bp_fields = pack_fields
        elif bounds_map and n and not semi:
            # partial integer coverage: fall back to the eager packer (rare)
            exec_._prepare_build_payload(bounds_map)
        return exec_

    # ---- sort-merge lookup --------------------------------------------
    def _lookup_sorted(
        self,
        probe_keys: jax.Array,
        probe_live: jax.Array,
        key_ok: jax.Array,
        probe_keys_hi: Optional[jax.Array] = None,
    ):
        """Match probe keys against the sorted build side.

        Returns (perm, pos, hit, live) of length cap, in **join-key order with
        live rows first**: perm[i] is the probe-row index occupying output slot
        i.  Emitting key-sorted output (instead of restoring probe order) costs
        the same second sort but leaves the batch pre-grouped for downstream
        aggregations — the engine's analog of the reference's streaming
        aggregation over sorted keys (velox/exec/StreamingAggregation.h).
        """
        cap = probe_keys.shape[0]
        B = self.build_size
        if B == 0:
            nothing = jnp.zeros((cap,), jnp.bool_)
            keeps_all = self.node.join_type in (JoinType.ANTI, JoinType.LEFT)
            return (
                jnp.arange(cap, dtype=jnp.int32),
                jnp.zeros((cap,), jnp.int32),
                nothing,
                probe_live if keeps_all else nothing,
            )
        kt = self.build_keys.dtype
        all_keys = jnp.concatenate([self.build_keys, probe_keys.astype(kt)])
        n_all = B + cap
        idxb = _index_bits(max(B, cap))
        packed = None
        if self.key_range is not None:
            # ---- packed fast path: ONE single-operand sort instead of a
            # 3-operand sort.  Key codes (bounded by the build key range),
            # the probe flag, and the per-class row index share one int64;
            # sort cost grows with operand count (ops/sortkey.py).
            lo, hi = self.key_range
            span = hi - lo + 2
            kb = int(span).bit_length()
            if kb + 1 + idxb <= 63:
                packed = True
        if packed:
            code = _key_codes(all_keys, lo, span)
            is_probe64 = jnp.concatenate(
                [jnp.zeros((B,), jnp.int64), jnp.ones((cap,), jnp.int64)]
            )
            orig64 = jnp.concatenate(
                [
                    jnp.arange(B, dtype=jnp.int64),
                    jnp.arange(cap, dtype=jnp.int64),
                ]
            )
            merged = (code << (1 + idxb)) | (is_probe64 << idxb) | orig64
            s = jax.lax.sort([merged], num_keys=1)[0]
            o_s = (s & ((1 << idxb) - 1)).astype(jnp.int32)
            p_s = ((s >> idxb) & 1).astype(jnp.int8)
            bidx = jnp.where(p_s == 0, o_s, jnp.int32(-1))
            last_build = jax.lax.cummax(bidx)
            cand = jnp.clip(last_build, 0, B - 1)
            # RAW-key equality: immune to out-of-range code collisions
            probe_raw = jnp.take(
                probe_keys.astype(kt), jnp.clip(o_s, 0, cap - 1), mode="clip"
            )
            hit = (
                (p_s == 1)
                & (last_build >= 0)
                & (jnp.take(self.build_keys, cand, mode="clip") == probe_raw)
            )
        else:
            is_probe = jnp.concatenate(
                [jnp.zeros((B,), jnp.int8), jnp.ones((cap,), jnp.int8)]
            )
            orig = jnp.concatenate(
                [
                    jnp.arange(B, dtype=jnp.int32),
                    jnp.arange(cap, dtype=jnp.int32),
                ]
            )
            if self.build_keys_hi is not None:
                # two-limb composite keys (>62 bits): sort by (hi, lo,
                # is_probe) — matches the build's lexsort order — and the
                # equality test covers BOTH limbs
                all_hi = jnp.concatenate(
                    [self.build_keys_hi, probe_keys_hi.astype(kt)]
                )
                h_s, k_s, p_s, o_s = jax.lax.sort(
                    (all_hi, all_keys, is_probe, orig), num_keys=3
                )
                bidx = jnp.where(p_s == 0, o_s, jnp.int32(-1))
                last_build = jax.lax.cummax(bidx)
                cand = jnp.clip(last_build, 0, B - 1)
                hit = (
                    (p_s == 1)
                    & (last_build >= 0)
                    & (jnp.take(self.build_keys, cand, mode="clip") == k_s)
                    & (
                        jnp.take(self.build_keys_hi, cand, mode="clip") == h_s
                    )
                )
            else:
                # sort by (key, is_probe): build rows precede equal probe keys
                k_s, p_s, o_s = jax.lax.sort(
                    (all_keys, is_probe, orig), num_keys=2
                )
                bidx = jnp.where(p_s == 0, o_s, jnp.int32(-1))
                last_build = jax.lax.cummax(bidx)
                cand = jnp.clip(last_build, 0, B - 1)
                hit = (
                    (p_s == 1)
                    & (last_build >= 0)
                    & (jnp.take(self.build_keys, cand, mode="clip") == k_s)
                )
        if self.build_valid is not None:
            # device builds pad to a bucket; sentinel tail slots never match
            hit = hit & jnp.take(self.build_valid, cand, mode="clip")
        # null/out-of-range probe keys never match
        ok_s = jnp.take(key_ok, jnp.clip(o_s, 0, cap - 1), mode="clip")
        hit = hit & ok_s
        # classify: live probe rows first (key-ordered), dead probe rows next,
        # build rows last; one stable flag sort compacts all three classes
        live_s = (p_s == 1) & jnp.take(
            probe_live, jnp.clip(o_s, 0, cap - 1), mode="clip"
        )
        jt = self.node.join_type
        if jt in (JoinType.INNER, JoinType.LEFT_SEMI):
            live_s = live_s & hit
        elif jt == JoinType.ANTI:
            live_s = live_s & ~hit
            if self.node.null_aware and self.n_valid_build_keys > 0:
                # NOT IN over a non-empty set: a NULL probe key compares
                # unknown against every element -> the row never passes
                live_s = live_s & ok_s
        # LEFT: probe-preserving — every live probe row stays live
        cb = _index_bits(B)
        if idxb + cb + 2 <= 63:
            # packed classification: a unique (flag, slot) key + one packed
            # payload — 2 sort operands instead of 5.  Key uniqueness makes
            # the order total, which subsumes the stable sort's determinism.
            posb = _index_bits(n_all)
            flag64 = jnp.where(
                p_s == 0,
                jnp.int64(2),
                jnp.where(live_s, jnp.int64(0), jnp.int64(1)),
            )
            pos = jnp.arange(n_all, dtype=jnp.int64)
            key2 = (flag64 << posb) | pos
            payload = (
                (o_s.astype(jnp.int64) << (cb + 2))
                | (cand.astype(jnp.int64) << 2)
                | (hit.astype(jnp.int64) << 1)
                | live_s.astype(jnp.int64)
            )
            _, pay = jax.lax.sort([key2, payload], num_keys=1)
            o2 = (pay >> (cb + 2)).astype(jnp.int32)
            pos2 = ((pay >> 2) & ((1 << cb) - 1)).astype(jnp.int32)
            hit2 = ((pay >> 1) & 1)[:cap].astype(jnp.bool_)
            live2 = (pay & 1)[:cap].astype(jnp.bool_)
            return o2[:cap], pos2[:cap], hit2, live2
        flag = jnp.where(
            p_s == 0, jnp.int8(2), jnp.where(live_s, jnp.int8(0), jnp.int8(1))
        )
        _, o2, pos2, hit2, live2 = jax.lax.sort(
            (flag, o_s, cand, hit.astype(jnp.int8), live_s.astype(jnp.int8)),
            num_keys=1,
            is_stable=True,
        )
        return (
            o2[:cap],
            pos2[:cap],
            hit2[:cap].astype(jnp.bool_),
            live2[:cap].astype(jnp.bool_),
        )

    # ---- expansion (N:M) probe: spans + expand ------------------------------
    def _probe_keys(self, batch: Batch):
        cap = batch.capacity
        probe_vals: List[jax.Array] = []
        key_ok = jnp.ones((cap,), dtype=jnp.bool_)
        for k in self.node.left_keys:
            values, validity = batch.column(k).decode(cap)
            probe_vals.append(values)
            if validity is not None:
                key_ok = key_ok & validity
        if self.normalizer is None:
            probe_keys = probe_vals[0].astype(jnp.int64)
        else:
            probe_keys, key_ok = self.normalizer.pack_device(probe_vals, key_ok)
        return probe_keys, key_ok

    def probe_spans(self, batch: Batch):
        """Phase 1 of an expansion join: per probe row (in ORIGINAL order) the
        matching build run span.  Returns (sizes, starts, hit, total)."""
        assert self.expansion
        cap = batch.capacity
        B = self.build_size
        jt = self.node.join_type
        probe_keys, key_ok = self._probe_keys(batch)
        live = batch.active_mask()
        all_keys = jnp.concatenate([self.build_keys, probe_keys])
        idxb = _index_bits(max(B, cap))
        cb = _index_bits(B)
        packed = False
        if self.key_range is not None:
            lo, hi = self.key_range
            span = hi - lo + 2
            kb = int(span).bit_length()
            packed = kb + 1 + idxb <= 63 and idxb + cb + 1 <= 63
        if packed:
            # single-operand merge sort + single-operand reorder sort (the
            # packing rationale of _lookup_sorted applies; see ops/sortkey.py)
            code = _key_codes(all_keys, lo, span)
            is_probe64 = jnp.concatenate(
                [jnp.zeros((B,), jnp.int64), jnp.ones((cap,), jnp.int64)]
            )
            orig64 = jnp.concatenate(
                [jnp.arange(B, dtype=jnp.int64), jnp.arange(cap, dtype=jnp.int64)]
            )
            merged = (code << (1 + idxb)) | (is_probe64 << idxb) | orig64
            s = jax.lax.sort([merged], num_keys=1)[0]
            o_s = (s & ((1 << idxb) - 1)).astype(jnp.int32)
            p_s = ((s >> idxb) & 1).astype(jnp.int8)
            bidx = jnp.where(p_s == 0, o_s, jnp.int32(-1))
            last_build = jax.lax.cummax(bidx)
            cand = jnp.clip(last_build, 0, B - 1)
            probe_raw = jnp.take(
                probe_keys, jnp.clip(o_s, 0, cap - 1), mode="clip"
            )
            hit_s = (
                (p_s == 1)
                & (last_build >= 0)
                & (jnp.take(self.build_keys, cand, mode="clip") == probe_raw)
            )
            # restore original probe order: probe rows get flag 0 and their
            # row id as a unique key; they occupy slots [0, cap)
            key2 = (
                ((1 - p_s.astype(jnp.int64)) << idxb) | o_s.astype(jnp.int64)
            )
            pay = (cand.astype(jnp.int64) << 1) | hit_s.astype(jnp.int64)
            _, pay_o = jax.lax.sort([key2, pay], num_keys=1)
            cand_p = (pay_o[:cap] >> 1).astype(jnp.int32)
            hit = (pay_o[:cap] & 1).astype(jnp.bool_) & key_ok & live
        else:
            is_probe = jnp.concatenate(
                [jnp.zeros((B,), jnp.int8), jnp.ones((cap,), jnp.int8)]
            )
            orig = jnp.concatenate(
                [jnp.arange(B, dtype=jnp.int32), jnp.arange(cap, dtype=jnp.int32)]
            )
            k_s, p_s, o_s = jax.lax.sort((all_keys, is_probe, orig), num_keys=2)
            bidx = jnp.where(p_s == 0, o_s, jnp.int32(-1))
            last_build = jax.lax.cummax(bidx)
            cand = jnp.clip(last_build, 0, B - 1)
            hit_s = (
                (p_s == 1)
                & (last_build >= 0)
                & (jnp.take(self.build_keys, cand, mode="clip") == k_s)
            )
            # restore original probe order: probe markers sort first (flag 0),
            # ordered by row id, so they occupy slots [0, cap)
            _, _, cand_o, hit_o = jax.lax.sort(
                (1 - p_s.astype(jnp.int32), o_s, cand, hit_s.astype(jnp.int8)),
                num_keys=2,
            )
            cand_p = cand_o[:cap]
            hit = hit_o[:cap].astype(jnp.bool_) & key_ok & live
        starts = jnp.take(self.run_start, cand_p, mode="clip")
        counts = jnp.take(self.run_count, cand_p, mode="clip")
        if jt in (JoinType.LEFT, JoinType.FULL):
            sizes = jnp.where(live, jnp.where(hit, counts, 1), 0)
        else:  # INNER
            sizes = jnp.where(hit, counts, 0)
        total = jnp.sum(sizes.astype(jnp.int64))
        if jt != JoinType.FULL:
            return sizes.astype(jnp.int32), starts, hit, total
        # FULL: per-build-slot matched flag for this tile — same merge trick
        # with probes sorted BEFORE equal build keys
        pk_masked = jnp.where(live & key_ok, probe_keys, jnp.int64(_KEY_SENTINEL))
        allk2 = jnp.concatenate([self.build_keys, pk_masked])
        if packed:
            code2 = _key_codes(allk2, lo, span)
            bflag64 = jnp.concatenate(
                [jnp.ones((B,), jnp.int64), jnp.zeros((cap,), jnp.int64)]
            )
            orig64b = jnp.concatenate(
                [jnp.arange(B, dtype=jnp.int64), jnp.arange(cap, dtype=jnp.int64)]
            )
            s2 = jax.lax.sort(
                [(code2 << (1 + idxb)) | (bflag64 << idxb) | orig64b],
                num_keys=1,
            )[0]
            o2 = (s2 & ((1 << idxb) - 1)).astype(jnp.int32)
            f2 = ((s2 >> idxb) & 1).astype(jnp.int32)
            k2 = jnp.where(
                f2 == 1,
                jnp.take(self.build_keys, jnp.clip(o2, 0, B - 1), mode="clip"),
                jnp.take(pk_masked, jnp.clip(o2, 0, cap - 1), mode="clip"),
            )
        else:
            bflag = jnp.concatenate(
                [jnp.ones((B,), jnp.int32), jnp.zeros((cap,), jnp.int32)]
            )
            orig2 = jnp.concatenate(
                [jnp.arange(B, dtype=jnp.int32), jnp.arange(cap, dtype=jnp.int32)]
            )
            k2, f2, o2 = jax.lax.sort((allk2, bflag, orig2), num_keys=2)
        # cummax over SLOT positions (monotone in sort order — original probe
        # indices are not): the most recent probe slot at/below this build
        # slot has key <= K; equal key <=> this build key is matched
        pos2 = jnp.arange(B + cap, dtype=jnp.int32)
        pmark = jnp.where(f2 == 0, pos2, jnp.int32(-1))
        lastslot = jax.lax.cummax(pmark)
        cand_eq = (lastslot >= 0) & (
            jnp.take(k2, jnp.clip(lastslot, 0, B + cap - 1), mode="clip") == k2
        )
        matched_s = (f2 == 1) & cand_eq & (k2 != jnp.int64(_KEY_SENTINEL))
        # route to build order: probes (flag 0) first, build rows in [cap:)
        if packed:
            keyd = (f2.astype(jnp.int64) << idxb) | o2.astype(jnp.int64)
            _, m_r = jax.lax.sort(
                [keyd, matched_s.astype(jnp.int64)], num_keys=1
            )
        else:
            _, _, m_r = jax.lax.sort(
                (f2, o2, matched_s.astype(jnp.int8)), num_keys=2
            )
        matched_b = m_r[cap:].astype(jnp.bool_)
        return sizes.astype(jnp.int32), starts, hit, total, matched_b

    def expand(self, batch: Batch, spans, out_cap: int) -> Batch:
        """Phase 2: materialize the joined rows into a [out_cap] batch."""
        from ..ops.segpool import dense_starts, owner_rows

        node = self.node
        cap = batch.capacity
        jt = node.join_type
        sizes, run_starts, hit = spans[0], spans[1], spans[2]
        out_starts = dense_starts(sizes)
        total32 = (out_starts[-1] + sizes[-1]).astype(jnp.int32)
        rowid = owner_rows(out_starts, total32, out_cap)
        pos = jnp.arange(out_cap, dtype=jnp.int32)
        emask = pos < total32
        offset = pos - jnp.take(out_starts, rowid, mode="clip")
        build_pos = jnp.take(run_starts, rowid, mode="clip") + offset
        build_pos = jnp.clip(build_pos, 0, max(self.build_size - 1, 0))
        row_hit = jnp.take(hit, rowid, mode="clip")

        left_schema = node.left.output_schema
        right_key_to_left = dict(zip(node.right_keys, node.left_keys))
        out_cols: List[Column] = []
        for name, dtype in zip(node.output_schema.names, node.output_schema.types):
            if name in left_schema:
                out_cols.append(batch.column(name).flatten(cap).gather(rowid))
            elif name in right_key_to_left:
                left_name = right_key_to_left[name]
                src = batch.column(left_name)
                values, validity = src.decode(cap)
                g = jnp.take(values, rowid, mode="clip")
                gv = row_hit if jt in (JoinType.LEFT, JoinType.FULL) else None
                out_cols.append(
                    Column.flat(g.astype(dtype.device_dtype), dtype, gv, src.strings)
                )
            else:
                values, validity = self.build_cols[name]
                g = jnp.take(values, build_pos, mode="clip")
                gv = (
                    None
                    if validity is None
                    else jnp.take(validity, build_pos, mode="clip")
                )
                if jt in (JoinType.LEFT, JoinType.FULL):
                    gv = row_hit if gv is None else (gv & row_hit)
                out_cols.append(
                    Column.flat(g, dtype, gv, self.build_tables.get(name))
                )
        return Batch(
            tuple(out_cols),
            total32,
            None,
            node.output_schema,
            out_cap,
        )

    # ---- FULL join: unmatched-build epilogue -------------------------------
    def init_matched(self) -> jax.Array:
        return jnp.zeros((self.build_size,), jnp.bool_)

    def full_tail(self, matched: jax.Array) -> Batch:
        """The FULL join's final batch: unmatched build rows, left side NULL."""
        from ..ops.compact import compaction_indices

        node = self.node
        B = self.build_size
        unmatched = ~matched
        if self.build_valid is not None:
            unmatched = unmatched & self.build_valid
        # sentinel-key slots here are null-key build rows (FULL keeps them;
        # builds for FULL are host-side, so there is no padding to exclude)
        perm, count = compaction_indices(unmatched)
        left_schema = node.left.output_schema
        out_cols: List[Column] = []
        for name, dtype in zip(node.output_schema.names, node.output_schema.types):
            if name in self.build_cols:
                values, validity = self.build_cols[name]
                g = jnp.take(values, perm, mode="clip")
                gv = (
                    None
                    if validity is None
                    else jnp.take(validity, perm, mode="clip")
                )
                out_cols.append(
                    Column.flat(g, dtype, gv, self.build_tables.get(name))
                )
            elif name in left_schema:
                out_cols.append(
                    Column.flat(
                        jnp.zeros((B,), dtype.device_dtype),
                        dtype,
                        jnp.zeros((B,), jnp.bool_),
                    )
                )
            else:
                raise KeyError(f"FULL join: no build column for {name!r}")
        return Batch(
            tuple(out_cols), count, None, node.output_schema, B
        )

    # ---- fused gather-free probe -------------------------------------------
    def _probe_fused(self, batch: Batch) -> Optional[Batch]:
        """ONE merge sort + one cummax scan; zero gathers in the common case.

        Premise from the engine's first target (not measured on a GPU): a
        random gather costs several times an extra sort operand, and bits
        already inside the sorted word are free.  So instead of the
        sort + classification-sort + per-column-gather pipeline
        (_lookup_sorted + probe), this path:

          1. packs (key code | is_probe | live | key-valid | ok | low) into
             one int64 word per row — build rows put their ENTIRE bit-packed
             payload (bp_packed) in the low field, probe rows their row id;
          2. sorts ONCE with the probe's output columns riding as extra
             non-key operands (build slots hold the build key so downstream
             presorted grouping sees intact runs);
          3. a cummax propagates the last build word to each probe row: the
             candidate's key code AND payload arrive in one scan — the
             reference's equivalent is its vectorized hash-table probe
             (velox/exec/HashTable.cpp:360);
          4. emits the batch in MERGED order (capacity B + cap) with build
             slots masked dead — no reorder sort; downstream operators handle
             selection masks and the output stays key-sorted for the
             presorted-aggregation path.

        Returns None (statically) when preconditions fail; the caller falls
        back to the classification-sort path."""
        plan = self._fused_static(batch.capacity)
        if plan is None:
            return None
        word, ops, vbits = self._fused_pre(batch, plan)
        sort_ops = [word] + list(ops) + list(vbits)
        out = jax.lax.sort(sort_ops, num_keys=1)
        return self._fused_post(plan, out[0], tuple(out[1:]))

    def _fused_static(self, cap: int):
        """Static eligibility + bit-layout plan for the fused probe; shared
        by the in-program path (_probe_fused) and the split-dispatch path
        (probe_split_host, ops/shared_sort.py).  None = not eligible."""
        node = self.node
        B = self.build_size
        if self.expansion or B == 0 or self.key_range is None:
            return None
        if self.build_keys_hi is not None or not self.allow_fused:
            return None
        left_schema = node.left.output_schema
        right_key_to_left = dict(zip(node.right_keys, node.left_keys))
        out_build = [
            n
            for n in node.output_columns
            if n in self.build_cols
            and not (n in left_schema or n in right_key_to_left)
        ]
        # complex-typed probe columns cannot ride as flat sort operands
        for name in node.output_columns:
            if name in left_schema and left_schema.type_of(name).is_complex:
                return None

        idxb = _index_bits(cap)
        tier1 = (not out_build) or (self.bp_plan is not None)
        if tier1:
            pb = self.bp_plan.total_bits if (out_build and self.bp_plan) else 0
            L = max(idxb, pb)
        else:
            L = max(idxb, _index_bits(B))
        lo, hi = self.key_range
        span = hi - lo + 2
        kb = int(span).bit_length()
        if kb + 4 + L > 63:
            if tier1 and out_build:
                # retry without the packed payload (tier 2 gathers instead)
                tier1 = False
                L = max(idxb, _index_bits(B))
                if kb + 4 + L > 63:
                    return None
            else:
                return None
        # the left columns the output needs (their count bounds the sort's
        # payload-operand count for the split path)
        needed_left: List[str] = []
        for name in node.output_schema.names:
            ln = name if name in left_schema else right_key_to_left.get(name)
            if ln is not None and ln not in needed_left:
                needed_left.append(ln)
        return {
            "cap": cap,
            "B": B,
            "tier1": tier1,
            "L": L,
            "lo": lo,
            "span": span,
            "out_build": out_build,
            "needed_left": needed_left,
            "left_schema": left_schema,
            "right_key_to_left": right_key_to_left,
        }

    def supports_split_probe(self, cap: int) -> bool:
        """Can this probe run as [pre glue] -> canonical shared sort ->
        [post glue] (three dispatches)?  Requires fused-probe eligibility and
        a payload count within the canonical bucket family."""
        from ..ops.shared_sort import _BUCKETS

        node = self.node
        if node.join_type not in (
            JoinType.INNER, JoinType.LEFT_SEMI, JoinType.ANTI, JoinType.LEFT
        ):
            return False
        if node.null_aware and self.build_has_null_key:
            return False  # statically-empty result; trivial fused program
        plan = self._fused_static(cap)
        if plan is None:
            return False
        # ops (needed_left) + at most one vbits operand
        return len(plan["needed_left"]) + 1 <= _BUCKETS[-1]

    def probe_output_capacity(self, cap: int) -> int:
        """Output capacity of probe() for a probe batch of capacity cap."""
        if self._fused_static(cap) is not None:
            return self.build_size + cap
        return cap

    def probe_split_host(self, batch: Batch) -> Batch:
        """HOST-LEVEL fused probe: dispatches pre-glue, the canonical shared
        sort (ops/shared_sort.py), and post-glue as separate programs.  Same
        math as _probe_fused, but the expensive-to-compile sort is a shared
        per-shape executable instead of part of this query's program
        (see ops/shared_sort.py)."""
        from ..ops.shared_sort import shared_sort_word

        plan = self._fused_static(batch.capacity)
        assert plan is not None, "call supports_split_probe first"
        jits = self._split_jits
        if jits is None:

            def pre(b):
                return self._fused_pre(b, plan)

            def post(s_word, payloads):
                return self._fused_post(plan, s_word, payloads)

            from ..utils.devtime import tjit

            jits = (
                tjit(pre, label="probe_pre"),
                tjit(post, label="probe_post"),
            )
            self._split_jits = jits
        pre_jit, post_jit = jits
        word, ops, vbits = pre_jit(batch)
        s_word, s_pay = shared_sort_word(word, list(ops) + list(vbits))
        return post_jit(s_word, tuple(s_pay))

    def _fused_pre(self, batch: Batch, plan):
        """Everything before the fused probe's sort: packed words + riding
        payload operands.  Returns (word, ops, vbits_tuple); records the
        per-column operand layout in self._split_meta for _fused_post."""
        node = self.node
        cap = plan["cap"]
        B = plan["B"]
        tier1 = plan["tier1"]
        L = plan["L"]
        lo, span = plan["lo"], plan["span"]
        out_build = plan["out_build"]
        left_schema = plan["left_schema"]

        # ---- probe keys + masks
        probe_vals: List[jax.Array] = []
        vb = jnp.ones((cap,), dtype=jnp.bool_)  # key validity (NULL test)
        for k in node.left_keys:
            values, validity = batch.column(k).decode(cap)
            probe_vals.append(values)
            if validity is not None:
                vb = vb & validity
        if self.normalizer is None:
            probe_keys = probe_vals[0].astype(jnp.int64)
            ok = vb
        else:
            probe_keys, ok = self.normalizer.pack_device(probe_vals, vb)
        live = batch.active_mask()

        all_keys = jnp.concatenate([self.build_keys, probe_keys])
        code = _key_codes(all_keys, lo, span)
        pcode = code[B:]
        ok = ok & (pcode >= 1) & (pcode <= span - 1)

        if tier1 and out_build:
            low_b = self.bp_packed
        elif tier1:
            low_b = jnp.zeros((B,), jnp.int64)
        else:
            low_b = jnp.arange(B, dtype=jnp.int64)
        word_b = (code[:B] << (4 + L)) | low_b
        flags = (
            (jnp.int64(1) << 3)
            | (live.astype(jnp.int64) << 2)
            | (vb.astype(jnp.int64) << 1)
            | ok.astype(jnp.int64)
        )
        word_p = ((pcode << 4) | flags) << L | jnp.arange(cap, dtype=jnp.int64)
        word = jnp.concatenate([word_b, word_p])

        # ---- carried probe columns (the left side of every output column)
        needed_left = plan["needed_left"]
        ops: List[jax.Array] = []
        meta = {}  # left name -> (op index, validity bit | -1, strings)
        vbits = None
        bit = 0
        single_key = self.normalizer is None
        for ln in needed_left:
            col = batch.column(ln)
            values, validity = col.decode(cap)
            if single_key and ln == node.left_keys[0]:
                # build slots keep their own key value so runs of equal keys
                # stay contiguous through dead slots (presorted grouping)
                pad = self.build_keys.astype(values.dtype)
            else:
                pad = jnp.zeros((B,), values.dtype)
            ops.append(jnp.concatenate([pad, values]))
            vbit = -1
            if validity is not None:
                add = jnp.concatenate(
                    [jnp.zeros((B,), jnp.int64), validity.astype(jnp.int64)]
                )
                vbits = add << bit if vbits is None else vbits | (add << bit)
                vbit = bit
                bit += 1
            meta[ln] = (len(ops) - 1, vbit, col.strings)
        # static operand layout, read back by _fused_post (trace of pre
        # always precedes trace of post for a given batch layout)
        self._split_meta = (meta, vbits is not None)
        return word, tuple(ops), (vbits,) if vbits is not None else ()

    def _fused_post(self, plan, s: jax.Array, payloads: Tuple[jax.Array, ...]):
        """Everything after the fused probe's sort: the cummax candidate
        scan + output-column assembly in merged order."""
        node = self.node
        jt = node.join_type
        cap = plan["cap"]
        B = plan["B"]
        tier1 = plan["tier1"]
        L = plan["L"]
        left_schema = plan["left_schema"]
        right_key_to_left = plan["right_key_to_left"]
        meta, has_vbits = self._split_meta
        out = (s,) + payloads
        out_vbits = out[-1] if has_vbits else None

        # ---- one scan: candidate build word per probe row
        is_probe = ((s >> (3 + L)) & 1).astype(jnp.bool_)
        bmark = jnp.where(is_probe, jnp.int64(-1), s)
        lastb = jax.lax.cummax(bmark)
        own_code = s >> (4 + L)
        cand_code = lastb >> (4 + L)  # -1 rows: negative, never equal
        live_s = ((s >> (2 + L)) & 1).astype(jnp.bool_)
        vb_s = ((s >> (1 + L)) & 1).astype(jnp.bool_)
        ok_s = ((s >> L) & 1).astype(jnp.bool_)
        hit = is_probe & ok_s & (lastb >= 0) & (cand_code == own_code)

        if jt in (JoinType.INNER, JoinType.LEFT_SEMI):
            live_out = live_s & hit
        elif jt == JoinType.ANTI:
            live_out = live_s & ~hit
            if self.node.null_aware and self.n_valid_build_keys > 0:
                # NOT IN over a non-empty set: a NULL probe key compares
                # unknown against every element -> never passes (out-of-range
                # NON-null keys do pass — they are definitely not in the set)
                live_out = live_out & vb_s
        else:  # LEFT: probe-preserving
            live_out = live_s
        live_out = live_out & is_probe

        # ---- output columns, merged order
        low_mask = (jnp.int64(1) << L) - 1
        lastb_low = lastb & low_mask
        n_all = B + cap
        out_cols: List[Column] = []
        for name, dtype in zip(
            node.output_schema.names, node.output_schema.types
        ):
            if name in left_schema:
                i, vbit, strings = meta[name]
                g = out[1 + i]
                gv = (
                    None
                    if vbit < 0
                    else ((out_vbits >> vbit) & 1).astype(jnp.bool_)
                )
                out_cols.append(Column.flat(g, dtype, gv, strings))
            elif name in right_key_to_left:
                ln = right_key_to_left[name]
                i, _, _ = meta[ln]
                g = out[1 + i]
                validity = hit if jt == JoinType.LEFT else None
                out_cols.append(
                    Column.flat(
                        g.astype(dtype.device_dtype), dtype, validity
                    )
                )
            else:  # build column
                values, validity = self.build_cols[name]
                if tier1:
                    fi = self.bp_fields.index(("v", name))
                    g = self.bp_plan.unpack(lastb_low, fi).astype(
                        dtype.device_dtype
                    )
                    gv = None
                    if ("n", name) in self.bp_fields:
                        ni = self.bp_fields.index(("n", name))
                        gv = self.bp_plan.unpack(lastb_low, ni) != 0
                else:
                    cand = lastb_low.astype(jnp.int32)
                    g = jnp.take(values, cand, mode="clip")
                    gv = (
                        None
                        if validity is None
                        else jnp.take(validity, cand, mode="clip")
                    )
                if jt == JoinType.LEFT:
                    gv = hit if gv is None else (gv & hit)
                out_cols.append(
                    Column.flat(g, dtype, gv, self.build_tables.get(name))
                )
        return Batch(
            tuple(out_cols),
            jnp.asarray(n_all, dtype=jnp.int32),
            live_out,
            node.output_schema,
            n_all,
        )

    # ---- trace-time probe -------------------------------------------------
    def probe(self, batch: Batch) -> Batch:
        node = self.node
        cap = batch.capacity
        left_schema = node.left.output_schema
        jt = node.join_type
        if jt not in (
            JoinType.INNER, JoinType.LEFT_SEMI, JoinType.ANTI, JoinType.LEFT
        ):
            raise NotImplementedError(f"join type {jt} not yet supported")
        assert not self.expansion, "expansion joins go through probe_spans/expand"
        if node.null_aware and self.build_has_null_key:
            # NOT IN (..., NULL): x NOT IN S is never TRUE when S holds a
            # NULL (it is FALSE or UNKNOWN) — the whole result is empty
            out_cols = [batch.column(n) for n in node.output_schema.names]
            return Batch(
                tuple(out_cols),
                jnp.asarray(0, dtype=jnp.int32),
                jnp.zeros((cap,), jnp.bool_),
                node.output_schema,
                cap,
            )

        fused = self._probe_fused(batch)
        if fused is not None:
            return fused

        probe_vals: List[jax.Array] = []
        key_ok = jnp.ones((cap,), dtype=jnp.bool_)
        for k in node.left_keys:
            values, validity = batch.column(k).decode(cap)
            probe_vals.append(values)
            if validity is not None:
                key_ok = key_ok & validity
        probe_keys_hi = None
        if self.normalizer is None:
            probe_keys = probe_vals[0].astype(jnp.int64)
        else:
            (probe_keys_hi, probe_keys), key_ok = (
                self.normalizer.pack_device_limbs(probe_vals, key_ok)
            )

        perm, pos, hit, live = self._lookup_sorted(
            probe_keys, batch.active_mask(), key_ok, probe_keys_hi
        )

        out_cols: List[Column] = []
        right_key_to_left = dict(zip(node.right_keys, node.left_keys))
        for name, dtype in zip(
            node.output_schema.names, node.output_schema.types
        ):
            if name in left_schema:
                col = batch.column(name)
                if dtype.is_complex:
                    # ARRAY/MAP/ROW probe columns: spans move with the rows,
                    # element pools stay put (same as the expansion probe)
                    out_cols.append(col.flatten(cap).gather(perm))
                    continue
                values, validity = col.decode(cap)
                g = jnp.take(values, perm, mode="clip")
                gv = (
                    None
                    if validity is None
                    else jnp.take(validity, perm, mode="clip")
                )
                out_cols.append(Column.flat(g, dtype, gv, col.strings))
            elif name in right_key_to_left:
                # a right key equals the corresponding left key on matched rows
                left_name = right_key_to_left[name]
                values = jnp.take(
                    probe_vals[list(node.left_keys).index(left_name)],
                    perm,
                    mode="clip",
                )
                validity = hit if jt == JoinType.LEFT else None
                out_cols.append(
                    Column.flat(
                        values.astype(dtype.device_dtype), dtype, validity
                    )
                )
            else:
                values, validity = self.build_cols[name]
                if self.build_size == 0:
                    gathered = jnp.zeros((cap,), dtype=dtype.device_dtype)
                    gv = jnp.zeros((cap,), dtype=jnp.bool_)
                else:
                    gathered = jnp.take(values, pos, mode="clip")
                    gv = (
                        None
                        if validity is None
                        else jnp.take(validity, pos, mode="clip")
                    )
                if jt == JoinType.LEFT:
                    gv = hit if gv is None else (gv & hit)
                out_cols.append(
                    Column.flat(gathered, dtype, gv, self.build_tables.get(name))
                )
        if node.filter is not None:
            raise NotImplementedError(
                "use FilterNode above an INNER join for non-equi conditions"
            )
        # rows were re-ordered: live rows form a key-sorted prefix; the batch's
        # length/selection are rebuilt from the lookup's liveness
        return Batch(
            tuple(out_cols),
            jnp.asarray(cap, dtype=jnp.int32),
            live,
            node.output_schema,
            cap,
        )


# ---------------------------------------------------------------------------
# Non-equi filters on existence joins (semi/anti): plan rewrite


def _filter_refs(e) -> set:
    from ..expr.ir import FieldAccess

    out = set()

    def walk(x):
        if isinstance(x, FieldAccess):
            out.add(x.name)
        for c in x.children:
            walk(c)

    walk(e)
    return out


def rewrite_filtered_existence_joins(node):
    """Lower LEFT_SEMI / ANTI joins that carry a non-equi filter.

    The reference evaluates the filter per candidate match inside HashProbe
    (velox/exec/HashProbe.cpp filter evaluation); this engine's existence
    joins deduplicate the build side and keep a single candidate per probe
    row, so a filter needs ALL matches.  Rewrite (plan-level, before
    linearization):

        uid     = AssignUniqueId(probe)
        matched = distinct uids of (uid INNER JOIN build ON keys, filter f)
        result  = uid SEMI/ANTI JOIN matched ON uid

    The probe subtree executes twice (once inside ``matched``); uids derive
    from global row offsets, so both executions agree.  RIGHT_SEMI flips to
    LEFT_SEMI first (the same lowering _linearize applies).
    """
    import dataclasses as _dc

    from ..plan.nodes import (
        AggregationNode,
        AggregationStep,
        AssignUniqueIdNode,
        PlanNode,
    )

    kids = {}
    for attr in ("source", "left", "right"):
        child = getattr(node, attr, None)
        if isinstance(child, PlanNode):
            kids[attr] = rewrite_filtered_existence_joins(child)
    inputs = getattr(node, "inputs", None)
    if inputs and all(isinstance(i, PlanNode) for i in inputs):
        kids["inputs"] = tuple(
            rewrite_filtered_existence_joins(i) for i in inputs
        )
    if kids:
        node = _dc.replace(node, **kids)
    if not isinstance(node, HashJoinNode) or node.filter is None:
        return node
    jt = node.join_type
    if jt == JoinType.RIGHT_SEMI:
        node = _dc.replace(
            node,
            left=node.right,
            right=node.left,
            left_keys=node.right_keys,
            right_keys=node.left_keys,
            join_type=JoinType.LEFT_SEMI,
        )
        jt = JoinType.LEFT_SEMI
    if jt == JoinType.FULL:
        return rewrite_full_filter(node)
    if jt not in (JoinType.LEFT_SEMI, JoinType.ANTI):
        return node
    if node.null_aware:
        return rewrite_null_aware_anti_filter(node)
    uid_name = f"__ejf_{node.id}"
    probe, build = node.left, node.right
    uid = AssignUniqueIdNode(probe, uid_name)
    # the INNER join's output must carry every column the filter reads
    # (_linearize evaluates the filter above the join)
    refs = _filter_refs(node.filter)
    inner_out = [uid_name] + [
        c
        for c in refs
        if c != uid_name
        and (c in probe.output_schema or c in build.output_schema)
    ]
    inner = HashJoinNode(
        uid,
        build,
        JoinType.INNER,
        node.left_keys,
        node.right_keys,
        tuple(inner_out),
        node.filter,
    )
    matched = AggregationNode(
        inner, AggregationStep.SINGLE, (uid_name,), (), ()
    )
    return HashJoinNode(
        uid,
        matched,
        jt,
        (uid_name,),
        (uid_name,),
        tuple(node.output_columns),
        id=node.id,
    )


def rewrite_null_aware_anti_filter(node: HashJoinNode) -> "PlanNode":
    """Null-aware ANTI join (NOT IN) carrying a non-equi filter.

    Reference semantics (velox/exec/HashProbe.cpp null-aware anti-join filter
    handling): a probe row is emitted iff NO build row b satisfies
    ``(keys equal OR probe key IS NULL OR build key IS NULL) AND filter(p,b)``
    — a NULL on either side makes the key comparison UNKNOWN, which NOT IN
    treats as a possible match, but the filter can still disqualify it.
    Lowered to supported primitives:

        uid = AssignUniqueId(probe)
        m1  = distinct uid of (uid INNER JOIN build ON keys, filter)
        m2  = distinct uid of (uid CROSS build[key IS NULL], filter)
        m3  = distinct uid of (uid[key IS NULL] CROSS build, filter)
        out = uid ANTI JOIN (m1 UNION ALL m2 UNION ALL m3) ON uid

    The cross joins only touch the NULL-key subsets (m2's build side, m3's
    probe side), so they stay small in practice — the same degradation the
    reference accepts for null-aware filter evaluation.
    """
    from ..dtypes import BIGINT, BOOLEAN
    from ..expr.ir import Call, Constant, FieldAccess, Special, SpecialForm
    from ..plan.nodes import (
        AggregationNode,
        AggregationStep,
        AssignUniqueIdNode,
        FilterNode,
        ProjectNode,
        UnionAllNode,
    )

    probe, build = node.left, node.right
    ls, rs = probe.output_schema, build.output_schema
    uid_name = f"__naf_{node.id}"
    uid = AssignUniqueIdNode(probe, uid_name)
    refs = _filter_refs(node.filter)
    probe_cols = [uid_name] + [c for c in refs if c in ls or c in node.left_keys]
    build_cols = [c for c in rs.names if c in refs or c in node.right_keys]
    inner_out = tuple(dict.fromkeys(probe_cols + build_cols))

    def distinct_uids(join):
        return AggregationNode(
            join, AggregationStep.SINGLE, (uid_name,), (), ()
        )

    def any_null(schema, keys):
        tests = [
            Call(BOOLEAN, "is_null", (FieldAccess(schema.type_of(k), k),))
            for k in keys
        ]
        return tests[0] if len(tests) == 1 else Special(
            BOOLEAN, SpecialForm.OR, tuple(tests)
        )

    def with_const_key(src, cols, key_name):
        names, exprs = [], []
        for c in cols:
            names.append(c)
            exprs.append(FieldAccess(src.output_schema.type_of(c), c))
        names.append(key_name)
        exprs.append(Constant(BIGINT, 1))
        return ProjectNode(src, tuple(names), tuple(exprs))

    def cross_matches(left_src, right_src):
        xl, xr = f"__naf_xl_{node.id}", f"__naf_xr_{node.id}"
        cl = with_const_key(left_src, probe_cols, xl)
        cr = with_const_key(right_src, build_cols, xr)
        join = HashJoinNode(
            cl, cr, JoinType.INNER, (xl,), (xr,), inner_out, node.filter
        )
        return distinct_uids(join)

    m1 = distinct_uids(
        HashJoinNode(
            uid,
            build,
            JoinType.INNER,
            node.left_keys,
            node.right_keys,
            inner_out,
            node.filter,
        )
    )
    m2 = cross_matches(uid, FilterNode(build, any_null(rs, node.right_keys)))
    m3 = cross_matches(FilterNode(uid, any_null(ls, node.left_keys)), build)
    matched = UnionAllNode((m1, m2, m3))
    return HashJoinNode(
        uid,
        matched,
        JoinType.ANTI,
        (uid_name,),
        (uid_name,),
        tuple(node.output_columns),
        id=node.id,
    )


def rewrite_left_filter_nm(node: HashJoinNode) -> HashJoinNode:
    """LEFT join + non-equi filter over a duplicate-key (N:M) build.

    The single-candidate null-out path (runner left_join_filter) cannot see
    all matches, so lower to supported primitives (reference behavior:
    HashProbe evaluates the filter per expanded match and emits the probe
    row null-extended when every match fails):

        uid     = AssignUniqueId(probe)
        inner   = uid INNER JOIN build ON keys, filter f   (N:M, filtered)
        result  = uid LEFT JOIN inner ON uid               (N:M, no filter)
    """
    import dataclasses as _dc

    from ..plan.nodes import AssignUniqueIdNode

    if node.join_type == JoinType.RIGHT:
        node = _dc.replace(
            node,
            left=node.right,
            right=node.left,
            left_keys=node.right_keys,
            right_keys=node.left_keys,
            join_type=JoinType.LEFT,
        )
    assert node.join_type == JoinType.LEFT and node.filter is not None
    uid_name = f"__ljf_{node.id}"
    uid = AssignUniqueIdNode(node.left, uid_name)
    ls = node.left.output_schema
    rs = node.right.output_schema
    refs = _filter_refs(node.filter)
    inner_out = [uid_name] + [
        c
        for c in dict.fromkeys(list(node.output_columns) + sorted(refs))
        if c in rs or (c in refs and c in ls)
    ]
    inner = HashJoinNode(
        uid,
        node.right,
        JoinType.INNER,
        node.left_keys,
        node.right_keys,
        tuple(inner_out),
        node.filter,
    )
    return HashJoinNode(
        uid,
        inner,
        JoinType.LEFT,
        (uid_name,),
        (uid_name,),
        tuple(node.output_columns),
        id=node.id + "_ljf",
    )


def rewrite_full_filter(node: HashJoinNode) -> "PlanNode":
    """FULL join + non-equi filter: matched pairs failing the filter count as
    unmatched on BOTH sides (reference: HashProbe filter + the FULL epilogue
    re-checking match flags).  Lowered to supported primitives:

        uidl  = AssignUniqueId(probe);  uidr = AssignUniqueId(build)
        inner = uidl INNER JOIN uidr ON keys, filter f
        left  = uidl LEFT JOIN inner ON uidl       (probe side + matches)
        ub    = uidr ANTI inner ON uidr            (builds with no pass)
        out   = left UNION ALL project(ub, probe cols as typed NULLs)
    """
    from ..expr.ir import Constant, FieldAccess
    from ..plan.nodes import AssignUniqueIdNode, ProjectNode, UnionAllNode

    ul, ur = f"__ffl_{node.id}", f"__ffr_{node.id}"
    uidl = AssignUniqueIdNode(node.left, ul)
    uidr = AssignUniqueIdNode(node.right, ur)
    ls, rs = node.left.output_schema, node.right.output_schema
    refs = _filter_refs(node.filter)
    inner_out = [ul, ur] + [
        c
        for c in dict.fromkeys(list(node.output_columns) + sorted(refs))
        if c in rs or (c in refs and c in ls)
    ]
    inner = HashJoinNode(
        uidl,
        uidr,
        JoinType.INNER,
        node.left_keys,
        node.right_keys,
        tuple(inner_out),
        node.filter,
    )
    left = HashJoinNode(
        uidl, inner, JoinType.LEFT, (ul,), (ul,), tuple(node.output_columns)
    )
    build_cols = [c for c in node.output_columns if c in rs]
    unmatched = HashJoinNode(
        uidr, inner, JoinType.ANTI, (ur,), (ur,), tuple(build_cols)
    )
    names, exprs = [], []
    for c in node.output_columns:
        names.append(c)
        if c in rs:
            exprs.append(FieldAccess(rs.type_of(c), c))
        else:
            exprs.append(Constant(ls.type_of(c), None))
    ub = ProjectNode(unmatched, tuple(names), tuple(exprs))
    return UnionAllNode((left, ub), id=node.id + "_ff")
