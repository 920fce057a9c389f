"""The port's chunk indexes against JAX's: `chunks_for_range` and
`transformed_start_offsets`, which the scrub gate reads to pin a corrupt
byte to its chunk, on seeded fixed and variable indexes."""

from __future__ import annotations

import numpy as np
import pytest

from tieredstorage_tpu.manifest import chunk_index as jax_index
from tieredstorage_tpu.storage.core import BytesRange as JaxRange
from tieredstorage_tpu_torch.manifest import chunk_index as port_index
from tieredstorage_tpu_torch.storage.core import BytesRange as PortRange


def _indexes(m, seed: int, variable: bool):
    rng = np.random.default_rng(seed)
    chunk = int(rng.integers(16, 200))
    size = int(rng.integers(0, 40)) * chunk + int(rng.integers(0, chunk))
    n = -(-size // chunk)
    if variable:
        builder = m.VariableSizeChunkIndexBuilder(chunk, size)
        sizes = rng.integers(1, 3 * chunk, max(n, 1))
    else:
        transformed = chunk + int(rng.integers(0, 40))
        builder = m.FixedSizeChunkIndexBuilder(chunk, size, transformed)
        sizes = [transformed] * max(n, 1)
        sizes[-1] = int(rng.integers(1, transformed + 1))
    for s in sizes[:-1]:
        builder.add_chunk(int(s))
    return builder.finish(int(sizes[-1])), size, rng


def _as_tuples(chunks):
    return [(c.id, c.original_position, c.original_size, c.transformed_position,
             c.transformed_size) for c in chunks]


@pytest.mark.parametrize("variable", [False, True], ids=["fixed", "variable"])
@pytest.mark.parametrize("seed", range(6))
def test_ranges_and_start_offsets_equal_jax(seed, variable):
    jax_idx, size, rng = _indexes(jax_index, seed, variable)
    port_idx, _, _ = _indexes(port_index, seed, variable)
    np.testing.assert_array_equal(port_idx.transformed_start_offsets(),
                                  jax_idx.transformed_start_offsets())
    assert port_idx.transformed_start_offsets().dtype == jax_idx.transformed_start_offsets().dtype
    for _ in range(20):
        start = int(rng.integers(0, size + 50))
        end = start + int(rng.integers(0, size + 50))
        assert _as_tuples(port_idx.chunks_for_range(PortRange.of(start, end))) == _as_tuples(
            jax_idx.chunks_for_range(JaxRange.of(start, end)))


def test_chunks_for_range_matches_the_reference_cases():
    """tests/test_manifest.py's cases, on the port."""
    idx = port_index.FixedSizeChunkIndex(100, 250, 110, 80)
    assert [c.id for c in idx.chunks_for_range(PortRange.of(0, 249))] == [0, 1, 2]
    assert [c.id for c in idx.chunks_for_range(PortRange.of(150, 180))] == [1]
    assert [c.id for c in idx.chunks_for_range(PortRange.of(99, 100))] == [0, 1]
    assert [c.id for c in idx.chunks_for_range(PortRange.of(200, 10_000))] == [2]
    assert idx.chunks_for_range(PortRange.of(250, 300)) == []
    aligned = port_index.FixedSizeChunkIndex(100, 300, 110, 110)
    assert [c.id for c in aligned.chunks_for_range(PortRange.of(250, 10_000))] == [2]
    assert [c.id for c in aligned.chunks_for_range(PortRange.of(0, 10_000))] == [0, 1, 2]
