"""Columnar batch layer: the Device re-design of the reference's vector layer.

Reference: velox/vector/BaseVector.h:69 (BaseVector + Flat/Constant/Dictionary
encodings, VectorEncoding.h:32), velox/vector/DecodedVector.h:76,
velox/vector/SelectivityVector.h:39.

Device-first design decisions (SURVEY.md §7):

* A ``Column`` is a struct-of-arrays pytree of fixed-capacity jnp arrays so a whole
  ``Batch`` can flow through ``jax.jit`` with **static shapes**.  The dynamic row
  count rides along as a traced int32 scalar (``Batch.length``); rows beyond it are
  padding.
* The reference's SelectivityVector becomes ``Batch.selection`` — a boolean mask over
  the capacity.  Filters narrow the mask; compaction (dense gather) happens only at
  operator boundaries that need density (see velox_tpu.ops.compact).
* Encodings FLAT / CONSTANT / DICTIONARY are kept because they are *algebraic*
  optimizations (eval-on-base + gather), not memory tricks; SEQUENCE/BIAS/LAZY from
  the reference are dropped — XLA fusion and the scan pipeline make them moot.
* ``decode`` is the DecodedVector analog: collapse any encoding to (values, validity).
  Inside jit this is a gather/broadcast that XLA fuses into the consumer.
* Strings on device are always int32 dictionary codes (see string_table.py).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import DataType, RowType, TypeKind
from .string_table import StringTable


class Encoding(str, Enum):
    FLAT = "FLAT"
    CONSTANT = "CONSTANT"
    DICTIONARY = "DICTIONARY"
    # run-length runs over a base of run values (velox SequenceVector,
    # vector/VectorEncoding.h:32): ``data`` holds int32 run LENGTHS, ``base``
    # the per-run values.  decode() expands on device with a broadcast
    # compare against the run end positions — O(capacity x n_runs) work
    # that XLA fuses into the consumer, so it is intended for genuinely
    # run-compressed columns (n_runs << capacity).
    SEQUENCE = "SEQUENCE"
    # narrow deltas from a shared bias value (velox BiasVector): ``base`` is
    # a CONSTANT column carrying the bias, ``data`` the narrow (int8/int16/
    # int32) deltas; decode() widens and adds in-program.
    BIAS = "BIAS"


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Column:
    """One column of a Batch.

    data:
      FLAT        -> values, shape [capacity]
      CONSTANT    -> scalar value, shape ()
      DICTIONARY  -> int32 indices into ``base``, shape [capacity]
    validity: optional bool array (True = valid / not NULL), shaped like data.
    base: the dictionary's base column (FLAT), present iff DICTIONARY.
    """

    data: jax.Array
    validity: Optional[jax.Array]
    base: Optional["Column"]
    dtype: DataType = dataclasses.field(metadata=dict(static=True))
    encoding: Encoding = dataclasses.field(metadata=dict(static=True))
    strings: Optional[StringTable] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # ARRAY/MAP: ``data`` is int32[capacity, 2] (start, size) spans and
    # ``children`` holds the element pool column(s) (ARRAY: one, MAP: key+value)
    # with their own fixed pool capacity (velox ArrayVector/MapVector analog).
    children: Tuple["Column", ...] = ()

    # ---- constructors ----------------------------------------------------
    @staticmethod
    def flat(
        data: jax.Array,
        dtype: DataType,
        validity: Optional[jax.Array] = None,
        strings: Optional[StringTable] = None,
    ) -> "Column":
        return Column(data, validity, None, dtype, Encoding.FLAT, strings)

    @staticmethod
    def constant(
        value,
        dtype: DataType,
        is_null: bool = False,
        strings: Optional[StringTable] = None,
    ) -> "Column":
        data = jnp.asarray(value, dtype=dtype.device_dtype)
        validity = jnp.asarray(False) if is_null else None
        return Column(data, validity, None, dtype, Encoding.CONSTANT, strings)

    @staticmethod
    def dictionary(
        indices: jax.Array,
        base: "Column",
        validity: Optional[jax.Array] = None,
    ) -> "Column":
        assert base.encoding == Encoding.FLAT, "dictionary base must be flat"
        return Column(
            indices, validity, base, base.dtype, Encoding.DICTIONARY, base.strings
        )

    @staticmethod
    def sequence(
        run_values: "Column",
        run_lengths,
        capacity: int,
    ) -> "Column":
        """Run-length column: row r takes the value of the run containing r.

        ``run_values`` is a FLAT column of per-run values (its validity is
        the per-run null flag); ``run_lengths`` the matching run lengths,
        which must sum to ``capacity``.  Reference: velox SequenceVector
        (vector/SequenceVector.h)."""
        assert run_values.encoding == Encoding.FLAT, "sequence base must be flat"
        lengths = jnp.asarray(run_lengths, dtype=jnp.int32)
        assert lengths.shape[0] == run_values.capacity
        assert int(jnp.sum(lengths)) == capacity, "run lengths must sum to capacity"
        return Column(
            lengths, None, run_values, run_values.dtype, Encoding.SEQUENCE,
            run_values.strings,
        )

    @staticmethod
    def bias(
        bias_value,
        deltas,
        dtype: DataType,
        validity: Optional[jax.Array] = None,
    ) -> "Column":
        """Bias column: value[r] = bias + deltas[r], deltas stored narrow.

        Reference: velox BiasVector (vector/BiasVector.h) — same trade:
        a 64-bit column whose values cluster near a center stores 1/2/4-byte
        deltas."""
        base = Column.constant(bias_value, dtype)
        d = jnp.asarray(deltas)
        assert jnp.issubdtype(d.dtype, jnp.integer)
        return Column(d, validity, base, dtype, Encoding.BIAS, None)

    # ---- shape -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        if self.encoding == Encoding.CONSTANT:
            raise ValueError("constant column has no capacity; use batch capacity")
        if self.encoding == Encoding.SEQUENCE:
            # data holds run lengths, not rows — row capacity comes from the
            # batch (like CONSTANT)
            raise ValueError("sequence column has no row capacity; use batch capacity")
        return self.data.shape[0]

    @property
    def is_constant(self) -> bool:
        return self.encoding == Encoding.CONSTANT

    # ---- DecodedVector analog -------------------------------------------
    def decode(self, capacity: int) -> Tuple[jax.Array, Optional[jax.Array]]:
        """Collapse any encoding stack to (flat values[capacity], validity|None).

        Reference: velox/vector/DecodedVector.h:76.  Inside jit the broadcast /
        gather fuses into the consuming computation.
        """
        if self.encoding == Encoding.FLAT:
            return self._widen(self.data), self.validity
        if self.encoding == Encoding.CONSTANT:
            values = jnp.broadcast_to(self.data, (capacity,) + self.data.shape[1:])
            values = self._widen(values)
            if self.validity is None:
                return values, None
            return values, jnp.broadcast_to(self.validity, (capacity,))
        if self.encoding == Encoding.SEQUENCE:
            # row -> run index: count of run END positions <= row.  A
            # broadcast compare fuses into the consumer; cost is
            # O(capacity x n_runs), i.e. cheap exactly when the encoding
            # is earning its keep (few runs).
            ends = jnp.cumsum(self.data)  # exclusive end of each run
            rows = jnp.arange(capacity, dtype=jnp.int32)
            run_idx = jnp.sum(
                (rows[:, None] >= ends[None, :]).astype(jnp.int32), axis=1
            )
            values = self._widen(
                jnp.take(self.base.data, run_idx, axis=0, mode="clip")
            )
            validity = None
            if self.base.validity is not None:
                validity = jnp.take(
                    self.base.validity, run_idx, axis=0, mode="clip"
                )
            return values, validity
        if self.encoding == Encoding.BIAS:
            wide = self.dtype.device_dtype
            values = self.base.data.astype(wide) + self.data.astype(wide)
            return values, self.validity
        # DICTIONARY
        base_values, base_validity = self.base.data, self.base.validity
        values = self._widen(jnp.take(base_values, self.data, axis=0, mode="clip"))
        validity = self.validity
        if base_validity is not None:
            inner = jnp.take(base_validity, self.data, axis=0, mode="clip")
            validity = inner if validity is None else (validity & inner)
        return values, validity

    def _widen(self, values: jax.Array) -> jax.Array:
        """Narrow-on-the-wire columns (int32 transfers of int64 data,
        Table.tile) widen at first decode — the astype fuses into the
        consuming program, so the win is pure host-link bytes."""
        if self.dtype.is_complex:
            return values
        want = self.dtype.device_dtype
        if values.dtype != want and not self.dtype.is_string:
            return values.astype(want)
        return values

    def values(self, capacity: int) -> jax.Array:
        return self.decode(capacity)[0]

    def validity_or_true(self, capacity: int) -> jax.Array:
        _, v = self.decode(capacity)
        if v is None:
            return jnp.ones((capacity,), dtype=jnp.bool_)
        return v

    # ---- transforms ------------------------------------------------------
    def gather(self, indices: jax.Array) -> "Column":
        """Row-reordering gather; result is FLAT with the indices' length."""
        if self.dtype.is_complex:
            # ARRAY/MAP: spans move with the rows; element pools stay put
            # (consumers re-densify via ops.segpool.normalize when they need
            # row order).  ROW: children are row-aligned and gather with us.
            data = jnp.take(self.data, indices, axis=0, mode="clip")
            validity = (
                None
                if self.validity is None
                else jnp.take(self.validity, indices, axis=0, mode="clip")
            )
            children = self.children
            if self.dtype.kind == TypeKind.ROW:
                children = tuple(c.gather(indices) for c in children)
            return dataclasses.replace(
                self, data=data, validity=validity, children=children
            )
        if self.encoding == Encoding.CONSTANT:
            cap = indices.shape[0]
            values, validity = self.decode(cap)
            return Column.flat(values, self.dtype, validity, self.strings)
        if self.encoding == Encoding.SEQUENCE:
            # compose: map gathered row positions to run indices, come back
            # as a DICTIONARY over the run values (no materialization)
            ends = jnp.cumsum(self.data)
            run_idx = jnp.sum(
                (indices[:, None] >= ends[None, :]).astype(jnp.int32), axis=1
            )
            return Column.dictionary(run_idx, self.base, None)
        if self.encoding == Encoding.BIAS:
            data = jnp.take(self.data, indices, axis=0, mode="clip")
            validity = (
                None
                if self.validity is None
                else jnp.take(self.validity, indices, axis=0, mode="clip")
            )
            return dataclasses.replace(self, data=data, validity=validity)
        if self.encoding == Encoding.DICTIONARY:
            # Compose index arrays instead of materializing the gather.
            new_idx = jnp.take(self.data, indices, axis=0, mode="clip")
            validity = (
                None
                if self.validity is None
                else jnp.take(self.validity, indices, axis=0, mode="clip")
            )
            return Column.dictionary(new_idx, self.base, validity)
        data = jnp.take(self.data, indices, axis=0, mode="clip")
        validity = (
            None
            if self.validity is None
            else jnp.take(self.validity, indices, axis=0, mode="clip")
        )
        return Column.flat(data, self.dtype, validity, self.strings)

    def flatten(self, capacity: int) -> "Column":
        if self.dtype.is_complex:
            return self  # complex columns are always span+pool form
        values, validity = self.decode(capacity)
        return Column.flat(values, self.dtype, validity, self.strings)

    # ---- host interop ----------------------------------------------------
    @staticmethod
    def from_numpy(
        arr: np.ndarray,
        dtype: DataType,
        validity: Optional[np.ndarray] = None,
        strings: Optional[StringTable] = None,
    ) -> "Column":
        if dtype.is_string and arr.dtype.kind in ("U", "S", "O"):
            table = strings if strings is not None else StringTable()
            # VARBINARY values are bytes and must round-trip as bytes —
            # str() of bytes would bake in python's b'...' repr
            codes = table.intern_all(
                ["" if v is None else (v if isinstance(v, bytes) else str(v))
                 for v in arr]
            )
            return Column.flat(
                jnp.asarray(codes),
                dtype,
                None if validity is None else jnp.asarray(validity, dtype=jnp.bool_),
                table,
            )
        np_arr = np.asarray(arr)
        want = np.dtype(dtype.device_dtype)
        if (
            not dtype.is_string
            and not dtype.is_complex
            and np_arr.dtype.kind in ("i", "u", "b")
            and want.kind == "i"
            and np_arr.itemsize <= want.itemsize
        ):
            # narrow transfer: ship the bounds-fitted width (Table.tile),
            # decode() widens INSIDE the consuming program — no separate
            # convert program to compile, no extra host-link bytes
            data = jnp.asarray(np_arr)
        elif np_arr.dtype == want:
            data = jnp.asarray(np_arr)
        else:
            # convert on the HOST: jnp.asarray(x, dtype=...) with a dtype
            # change uploads then compiles an on-device convert program
            data = jnp.asarray(np_arr.astype(want, copy=False))
        v = None if validity is None else jnp.asarray(validity, dtype=jnp.bool_)
        return Column.flat(data, dtype, v, strings)

    def to_numpy(self, length: int, decode_strings: bool = True):
        """Materialize the first ``length`` rows on the host.

        Returns (values, validity_or_None); strings decode to object arrays,
        ARRAY/MAP columns to object arrays of python lists/dicts.
        """
        if self.dtype.is_complex:
            from .complex import column_to_host

            seg, validity = column_to_host(self, length)
            values = np.empty(length, dtype=object)
            values[:] = seg.to_pylist()
            return values, validity
        cap = (
            length
            if self.is_constant or self.encoding == Encoding.SEQUENCE
            else self.capacity
        )
        values, validity = self.decode(cap)
        values = np.asarray(values)[:length]
        validity_np = None if validity is None else np.asarray(validity)[:length]
        if self.dtype.is_string and self.strings is not None and decode_strings:
            values = self.strings.decode(values)
        if self.dtype.kind == TypeKind.DECIMAL:
            values = values.astype(np.float64) / (10.0 ** self.dtype.scale)
        return values, validity_np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Batch:
    """A fixed-capacity batch of rows: the reference's RowVector + SelectivityVector.

    ``length`` (traced int32) is the number of materialized rows; ``selection``
    optionally masks a subset of them as live.  Rows in [length, capacity) are
    padding and always dead.
    """

    columns: Tuple[Column, ...]
    length: jax.Array
    selection: Optional[jax.Array]
    schema: RowType = dataclasses.field(metadata=dict(static=True))
    capacity: int = dataclasses.field(metadata=dict(static=True))
    # global row index of this tile's first row (traced; lets operators such
    # as AssignUniqueId derive task-wide row positions without host sync)
    row_offset: Optional[jax.Array] = None

    # ---- constructors ----------------------------------------------------
    @staticmethod
    def make(
        schema: RowType,
        columns: Sequence[Column],
        length: Union[int, jax.Array],
        selection: Optional[jax.Array] = None,
        capacity: Optional[int] = None,
        row_offset: Union[int, jax.Array, None] = None,
    ) -> "Batch":
        if capacity is None:
            capacity = next(
                c.capacity
                for c in columns
                if c.encoding not in (Encoding.CONSTANT, Encoding.SEQUENCE)
            )
        return Batch(
            tuple(columns),
            jnp.asarray(length, dtype=jnp.int32),
            selection,
            schema,
            capacity,
            None if row_offset is None else jnp.asarray(row_offset, jnp.int64),
        )

    @staticmethod
    def from_numpy(
        schema: RowType,
        arrays: Sequence[np.ndarray],
        validities: Optional[Sequence[Optional[np.ndarray]]] = None,
        string_tables: Optional[Sequence[Optional[StringTable]]] = None,
        capacity: Optional[int] = None,
    ) -> "Batch":
        n = len(arrays[0]) if arrays else 0
        cap = capacity if capacity is not None else max(n, 1)
        cols = []
        for i, (name, dtype) in enumerate(zip(schema.names, schema.types)):
            arr = np.asarray(arrays[i])
            validity = validities[i] if validities else None
            table = string_tables[i] if string_tables else None
            if len(arr) < cap:
                pad = cap - len(arr)
                if arr.dtype.kind in ("U", "S", "O"):
                    arr = np.concatenate([arr, np.asarray([""] * pad, dtype=object)])
                else:
                    arr = np.concatenate([arr, np.zeros(pad, dtype=arr.dtype)])
                if validity is not None:
                    validity = np.concatenate([validity, np.zeros(pad, dtype=bool)])
            cols.append(Column.from_numpy(arr, dtype, validity, table))
        return Batch.make(schema, cols, n, capacity=cap)

    # ---- access ----------------------------------------------------------
    def column(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def active_mask(self) -> jax.Array:
        """bool[capacity]: rows that are materialized AND selected."""
        mask = (
            jnp.arange(self.capacity, dtype=jnp.int32) < self.length
        )
        if self.selection is not None:
            mask = mask & self.selection
        return mask

    def num_active(self) -> jax.Array:
        if self.selection is None:
            return self.length
        return jnp.sum(self.active_mask()).astype(jnp.int32)

    # ---- transforms ------------------------------------------------------
    def with_selection(self, selection: jax.Array) -> "Batch":
        if self.selection is not None:
            selection = selection & self.selection
        return dataclasses.replace(self, selection=selection)

    def project(self, names: Sequence[str], schema: Optional[RowType] = None) -> "Batch":
        cols = tuple(self.column(n) for n in names)
        schema = schema or RowType(names, [self.schema.type_of(n) for n in names])
        return dataclasses.replace(self, columns=cols, schema=schema)

    def with_columns(self, schema: RowType, columns: Sequence[Column]) -> "Batch":
        return dataclasses.replace(self, columns=tuple(columns), schema=schema)

    # ---- host interop ----------------------------------------------------
    def to_pydict(self, decode_strings: bool = True) -> dict:
        """Materialize live rows host-side as {name: numpy array} (None for NULL)."""
        n = int(self.length)
        if self.selection is not None:
            keep = np.asarray(self.active_mask())
        else:
            keep = None
        out = {}
        for name, col in zip(self.schema.names, self.columns):
            values, validity = col.to_numpy(n, decode_strings=decode_strings)
            if keep is not None:
                values = values[keep[:n]]
                validity = None if validity is None else validity[keep[:n]]
            if validity is not None and not validity.all():
                values = values.astype(object)
                values[~validity] = None
            out[name] = values
        return out

    def to_pandas(self, decode_strings: bool = True):
        import pandas as pd

        return pd.DataFrame(self.to_pydict(decode_strings=decode_strings))
