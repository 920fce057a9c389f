"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with sm_90a and nvcc (the kernels have no CPU
mode), so they carry the `cuda` marker and skip elsewhere. The file imports
neither JAX nor the JAX package, so it runs on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix
from tieredstorage_tpu_torch.ops import _cuda, aes_bitsliced, gcm, ghash_cuda
from tieredstorage_tpu_torch.ops.aes import key_expansion
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tests.torch_huffman_regimes import REGIMES, regimes

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _on(device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


@pytest.mark.parametrize("batch,n_blocks,first", [
    (1, 1, 1), (3, 1000, 2**32 - 50), (2, 257, 7),
    (1, 262_145, 1), (16, 262_145, 1),  # a fetched 4 MiB chunk and the 64 MiB copy window
    (2, 33, 2**32 - 40),  # part of one warp's 8 quads, the counter wrapping inside the words
])
def test_aes_keystream_kernel_matches_plain(device, batch, n_blocks, first):
    rng = np.random.default_rng(n_blocks)
    rk = _on(device, key_expansion(rng.bytes(32)))
    ivs = _on(device, rng.integers(0, 256, (batch, 12), dtype=np.uint8))
    before = _cuda.launch_counts()["aes_ctr_keystream"]
    got = aes_bitsliced.ctr_keystream_batch(rk, ivs, first, n_blocks)
    assert _cuda.launch_counts()["aes_ctr_keystream"] == before + 1
    assert torch.equal(got, aes_bitsliced.ctr_keystream_batch_plain(rk, ivs, first, n_blocks))


@pytest.mark.parametrize("k,groups,rows", [(256, 3, 5), (2048, 4, 2), (48, 1, 7)])
def test_ghash_kernels_match_plain(device, k, groups, rows):
    rng = np.random.default_rng(k + groups)
    w1 = _on(device, rng.integers(0, 2, (8, k, 128), dtype=np.int8))
    step = _on(device, rng.integers(0, 2, (128, 128), dtype=np.int8))
    ops = ghash_cuda.GhashOperands.build(w1, step)
    data = _on(device, rng.integers(0, 256, (rows, groups * k), dtype=np.uint8))
    flat = data.reshape(rows * groups, k)
    assert torch.equal(ghash_cuda.ghash_level1(flat, ops), ghash_cuda.ghash_level1_plain(flat, w1))
    if groups > 1:
        assert torch.equal(ghash_cuda.ghash_tree(data, ops), ghash_cuda.ghash_tree_plain(data, w1, step))


@pytest.fixture(scope="module")
def chunk_context():
    rng = np.random.default_rng(5)
    return gcm.make_context(rng.bytes(32), rng.bytes(32), 4 << 20)


@pytest.mark.parametrize(
    "rows,groups",
    [(1, 2048), (16, 2048), (3, 37)],
    ids=["fetch-4MiB", "window-16x4MiB", "ragged-slices"],
)
def test_ghash_tree_kernel_on_real_context(device, chunk_context, rows, groups):
    """The tree on a 4 MiB context's operands (K = 2048) at the fetch's and
    the copy window's shapes, and at a group count the 16-group slices do
    not tile: one counted launch, the plain version's bits."""
    w1, step = _on(device, chunk_context.agg_mats[0]), _on(device, chunk_context.step_mat)
    ops = ghash_cuda.GhashOperands.build(w1, step)
    assert ops.k_bytes == 2048 and _cuda.tree_slice() == 16
    want_slice = ghash_cuda.pack_step(ghash_cuda.step_power(step.cpu(), 16))
    assert torch.equal(ops.slice_step_words.cpu(), want_slice)
    data = _on(device, np.random.default_rng(rows + groups).integers(
        0, 256, (rows, groups * ops.k_bytes), dtype=np.uint8))
    before = _cuda.launch_counts()["ghash_tree"]
    got = ghash_cuda.ghash_tree(data, ops)
    assert _cuda.launch_counts()["ghash_tree"] == before + 1
    assert torch.equal(got, ghash_cuda.ghash_tree_plain(data, w1, step))


def test_packed_window_on_card_matches_cpu(device):
    rng = np.random.default_rng(3)
    ctx = gcm.make_context(rng.bytes(32), rng.bytes(32), 4096 * 3 + 5)
    packed = rng.integers(0, 256, (3, ctx.chunk_bytes + 16), dtype=np.uint8)
    want = gcm.gcm_window_packed(ctx, None, torch.from_numpy(packed.copy()), decrypt=False)
    got = gcm.gcm_window_packed(ctx, None, _on(device, packed), decrypt=False)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("varlen", [False, True], ids=["fixed", "varlen"])
def test_window_program_does_not_wait_for_the_device(device, varlen):
    """A warm window program only enqueues: no host->device copy from
    pageable memory (or other sync) makes the host wait for earlier
    kernels, so the backend's staging pipeline can overlap windows."""
    rng = np.random.default_rng(4)
    key, aad = rng.bytes(32), rng.bytes(32)
    if varlen:
        ctx = gcm.make_varlen_context(key, aad, 5000)
        width = ctx.max_bytes
        packed = np.zeros((2, width + 16), np.uint8)
        packed[:, width + 12:] = np.asarray([5000, 17], "<u4").view(np.uint8).reshape(2, 4)
        run = lambda t: gcm.gcm_varlen_window_packed(ctx, None, t, None, decrypt=False, donate=True)  # noqa: E731
    else:
        ctx = gcm.make_context(key, aad, 4096 * 3)
        packed = rng.integers(0, 256, (2, ctx.chunk_bytes + 16), dtype=np.uint8)
        run = lambda t: gcm.gcm_window_packed(ctx, None, t, decrypt=False, donate=True)  # noqa: E731
    run(_on(device, packed))  # device constants built, kernels loaded
    staged = _on(device, packed)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second of device work ahead of the window
    run(staged)
    done = torch.cuda.Event()
    done.record()
    assert not done.query()  # the host got here while the device was still busy
    torch.cuda.synchronize()


def test_cuda_wrappers_refuse_bad_operands(device):
    ops = ghash_cuda.GhashOperands.build(torch.zeros((8, 32, 128), dtype=torch.int8), None)
    with pytest.raises(ValueError, match="operands on cpu"):
        ghash_cuda.ghash_level1(torch.zeros((2, 32), dtype=torch.uint8, device=device), ops)


HOT_CHUNK = 1 << 20
HOT_CHUNKS = 5


@pytest.fixture
def hot_rsm(device, tmp_path):
    """The port's RSM on the card with the hot-window tier only, over a
    copied 5 MiB encrypted segment of 1 MiB chunks."""
    rng = np.random.default_rng(9)
    log = rng.bytes(HOT_CHUNKS * HOT_CHUNK)
    paths = {}
    for name, data in (("log", log), ("index", rng.bytes(48)), ("timeindex", rng.bytes(72)),
                       ("snapshot", rng.bytes(40))):
        paths[name] = tmp_path / f"00000000000000000000.{name}"
        paths[name].write_bytes(data)
    tip = metadata.TopicIdPartition(metadata.KafkaUuid(rng.bytes(16)), metadata.TopicPartition("t", 0))
    md = metadata.RemoteLogSegmentMetadata(
        remote_log_segment_id=metadata.RemoteLogSegmentId(tip, metadata.KafkaUuid(rng.bytes(16))),
        start_offset=0, end_offset=99, segment_size_in_bytes=len(log),
    )
    sd = metadata.LogSegmentData(
        log_segment=paths["log"], offset_index=paths["index"], time_index=paths["timeindex"],
        producer_snapshot_index=paths["snapshot"], transaction_index=None,
        leader_epoch_index=b"0\n1\n0 0\n",
    )
    pub, priv = generate_key_pair_pem_files(tmp_path, prefix="hot")
    store = tmp_path / "store"
    store.mkdir()
    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(store), "chunk.size": HOT_CHUNK, "key.prefix": "hot/",
        "transform.device": str(device), "encryption.enabled": True,
        "encryption.key.pair.id": "k", "encryption.key.pairs": "k",
        "encryption.key.pairs.k.public.key.file": str(pub),
        "encryption.key.pairs.k.private.key.file": str(priv),
        "cache.device.bytes": 64 << 20,
    })
    rsm.copy_log_segment_data(md, sd)
    yield rsm, md, log, ObjectKeyFactory("hot/", False).key(md, Suffix.LOG)
    rsm.close()


def _read(rsm, md, start, end) -> bytes:
    with rsm.fetch_log_segment(md, start, end) as stream:
        return stream.read()


def test_hot_window_survives_later_windows_of_its_shape(hot_rsm):
    """The retention probe on the card: the retained CUDA tensor of an
    admitted one-row window still holds its plaintext after three more
    one-row windows of the same shape were decrypted."""
    rsm, md, log, log_key = hot_rsm
    hot = rsm.device_hot_cache
    for _ in range(2):  # first touch decrypts, the second admits
        assert _read(rsm, md, 0, 99) == log[:100]
    assert hot.admissions == 1 and hot.device_windows == 1
    for cid in (1, 2, 3):
        start = cid * HOT_CHUNK
        assert _read(rsm, md, start, start + 99) == log[start : start + 100]
    [row] = hot.device_rows(log_key, [0])
    assert row.is_cuda and row.shape == (HOT_CHUNK + 16,)
    assert row[:HOT_CHUNK].cpu().numpy().tobytes() == log[:HOT_CHUNK]
    assert hot.resident_device_bytes == HOT_CHUNK + 16


def test_hot_serve_makes_no_gcm_launch(hot_rsm):
    """Three whole-segment sweeps: the first decrypts, the second admits,
    the third is served from the hot tier with no GCM window program and no
    kernel launch; device_rows is a view, no launch either."""
    rsm, md, log, log_key = hot_rsm
    hot = rsm.device_hot_cache
    for sweep in range(3):
        before, kernels = gcm.device_dispatches(), _cuda.launch_counts()
        assert _read(rsm, md, 0, None) == log
        if sweep == 0:
            assert gcm.device_dispatches() - before == HOT_CHUNKS
    assert gcm.device_dispatches() == before
    assert _cuda.launch_counts() == kernels
    assert hot.device_windows == HOT_CHUNKS and hot.hits == HOT_CHUNKS
    rows = hot.device_rows(log_key, [4, 1])
    assert gcm.device_dispatches() == before
    for cid, row in zip((4, 1), rows):
        assert row[:HOT_CHUNK].cpu().numpy().tobytes() == log[cid * HOT_CHUNK : (cid + 1) * HOT_CHUNK]


def test_merged_flush_on_the_card_matches_unbatched_windows(device):
    """Three decrypt windows of one key, coalesced into one merged launch
    (padded to 8 rows) on the card, against the same windows decrypted one
    by one; then the same three windows encrypted in one merged launch."""
    import threading

    from tieredstorage_tpu_torch.security.aes import DataKeyAndAAD
    from tieredstorage_tpu_torch.transform.api import DetransformOptions, TransformOptions
    from tieredstorage_tpu_torch.transform.batcher import WindowBatcher
    from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend

    rng = np.random.default_rng(61)
    enc = DataKeyAndAAD(rng.bytes(32), rng.bytes(32))
    windows = [[rng.bytes(1 << 20), rng.bytes((1 << 20) - 100 * i)] for i in range(3)]
    plain = CudaTransformBackend()
    plain.configure({})
    wires = [plain.transform(w, TransformOptions(encryption=enc)) for w in windows]
    unbatched = [plain.detransform(w, DetransformOptions(encryption=enc)) for w in wires]
    assert unbatched == windows

    backend = CudaTransformBackend()
    backend.configure({})
    batcher = WindowBatcher(backend, wait_ms=50)
    batcher._inflight += 1  # park the fast path: every submit queues
    backend.batcher = batcher
    results: list = [None] * 3
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, backend.detransform(wires[i], DetransformOptions(encryption=enc)))) for i in range(3)]
    for t in threads:
        t.start()
    with batcher._cond:
        assert batcher._cond.wait_for(
            lambda: sum(len(v) for v in batcher._buckets.values()) == 3, timeout=60)
    rows_before = _cuda.launch_rows()["aes_ctr_keystream"].get(8, 0)
    assert batcher.flush_now() == 1
    for t in threads:
        t.join(timeout=60)
    assert results == unbatched
    assert (batcher.launches, batcher.batched_windows) == (1, 3)
    assert _cuda.launch_rows()["aes_ctr_keystream"].get(8, 0) == rows_before + 1

    ivs = [[rng.bytes(12) for _ in w] for w in windows]
    handles = [batcher.submit_encrypt(w, TransformOptions(encryption=enc, ivs=iv))
               for w, iv in zip(windows, ivs)]
    assert batcher.flush_now() == 1
    assert [h.wait() for h in handles] == [
        plain.transform(w, TransformOptions(encryption=enc, ivs=iv)) for w, iv in zip(windows, ivs)
    ]
    plain.close()
    backend.close()


def test_crc32c_batch_on_the_card_matches_the_host_table(device):
    """16 stored 4 MiB chunks (4 MiB + 28 B each, left-padded to 16 B) in
    one device group, against the host table."""
    from tieredstorage_tpu_torch.ops.crc32c import crc32c_batch, crc32c_host

    rng = np.random.default_rng(62)
    chunks = [rng.bytes((4 << 20) + 28) for _ in range(16)]
    assert crc32c_batch(chunks, device) == [crc32c_host(c) for c in chunks]


def _log_rows(n_rows: int, size: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        recs = b"".join(b"offset=%d key=user-%d value=" % (i, rng.integers(0, 999)) + rng.bytes(8)
                        for i in range(size // 30 + 1))
        rows.append(recs[:size])
    return rows


def _decode_operands(rows: list[bytes], device) -> list[torch.Tensor]:
    """The decoder's operands for `rows`, built as a fetch builds them: the
    port's encoder on `device`, the frames checked, then laid out."""
    from tieredstorage_tpu_torch.transform import thuff

    _, coded = thuff.parse_frames(thuff.compress_batch(rows, device=device))
    assert len(coded) == len(rows)  # every row was coded, none RAW-framed
    return thuff.decode_operands(coded, device)


@pytest.mark.parametrize("n_rows,size", [
    (1, 4 << 20), (16, 4 << 20),  # a fetched chunk and a 64 MiB window
    (3, 4096 - 1), (2, 4096), (1, 1000),  # a row under 1000 bytes is RAW-framed
])
def test_huffman_decode_kernel_matches_plain(device, n_rows, size):
    from tieredstorage_tpu_torch.ops import huffman

    rows = _log_rows(n_rows, size, seed=size + n_rows)
    words, jump, *tabs = _decode_operands(rows, device)
    before = _cuda.launch_counts()["huffman_decode"]
    symbols, final = huffman.decode_batch(words, jump, *tabs)
    assert _cuda.launch_counts()["huffman_decode"] == before + 1
    want_symbols, want_final = huffman.decode_batch_plain(words, jump, *tabs)
    assert torch.equal(symbols, want_symbols) and torch.equal(final, want_final)
    for i, row in enumerate(rows):
        assert symbols[i, : len(row)].cpu().numpy().tobytes() == row


def test_huffman_decode_kernel_matches_plain_on_corrupt_streams(device):
    from tieredstorage_tpu_torch.ops import huffman

    words, jump, *tabs = _decode_operands(_log_rows(4, 3 * 4096 + 5, seed=9), device)
    gen = torch.Generator(device="cpu").manual_seed(9)
    noise = torch.randint(-(2**31), 2**31 - 1, (4, 64), generator=gen, dtype=torch.int32)
    words = words.clone()
    words[:, 10:74] = noise.to(device)
    jump = jump.clone()
    jump[0, 1] = -7
    jump[1, 2] = 2**31 - 100
    got = huffman.decode_batch(words, jump, *tabs)
    want = huffman.decode_batch_plain(words, jump, *tabs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("tile", [1, 400], ids=["split", "per-lane"])
@pytest.mark.parametrize("regime", REGIMES)
def test_huffman_decode_kernel_matches_plain_in_every_regime(device, regime, tile):
    """4 rows of 4 jump blocks take the split kernel; the same rows 400
    times over (6400 lanes) take one thread per lane."""
    from tieredstorage_tpu_torch.ops import huffman

    base = [t.cpu().numpy() for t in _decode_operands(_log_rows(4, 3 * 4096 + 5, seed=9), device)]
    words, jump, tabs = regimes(base[0].view(np.uint32), base[1], base[2:], seed=5)[regime]
    words, jump, *tabs = (np.tile(a, (tile, 1)) for a in (words, jump, *tabs))
    assert (_cuda.decode_shape(jump.size)[1] > 1) == (tile == 1)
    ops = [_on(device, words.view(np.int32)), _on(device, jump), *(_on(device, t) for t in tabs)]
    before = _cuda.launch_counts()["huffman_decode"]
    got = huffman.decode_batch(*ops)
    assert _cuda.launch_counts()["huffman_decode"] == before + 1
    want = huffman.decode_batch_plain(*ops)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_huffman_decode_kernel_takes_words_that_are_not_16_byte_aligned(device):
    """The kernel reads words 16 bytes at a time; a view one odd-width row
    in is copied first, and decodes as the plain version does."""
    from tieredstorage_tpu_torch.ops import huffman

    words, jump, *tabs = _decode_operands(_log_rows(2, 3 * 4096 + 5, seed=3), device)
    ops = [t[1:] for t in (words, jump, *tabs)]
    assert ops[0].shape[1] % 4 and ops[0].data_ptr() % 16
    got = huffman.decode_batch(*ops)
    want = huffman.decode_batch_plain(*ops)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_huffman_decode_kernel_on_a_fixed_length_code_row(device):
    """Every symbol coded in 8 bits: offsets that differ mod 8 never meet."""
    from tieredstorage_tpu_torch.ops import huffman
    from tieredstorage_tpu_torch.transform import thuff

    rng = np.random.default_rng(8)
    n = 3 * 4096 + 100
    data = rng.integers(0, 256, (1, n), dtype=np.uint8)
    lengths = np.full((1, 256), 8, np.int32)
    codes_rev = thuff.encode_tables(lengths[0])[None, :]
    words, _, jump = huffman.encode_batch(*(_on(device, a) for a in (
        data, np.array([n], np.int32), codes_rev, lengths)))
    tabs = [_on(device, np.asarray(t, np.int32)[None, :]) for t in thuff.decode_tables(lengths[0])]
    ops = [huffman.to_int32_bits(words), jump.to(torch.int32), *tabs]
    symbols, final = huffman.decode_batch(*ops)
    want = huffman.decode_batch_plain(*ops)
    assert torch.equal(symbols, want[0]) and torch.equal(final, want[1])
    assert symbols[0, :n].cpu().numpy().tobytes() == data.tobytes()
    assert final[0, :3].tolist() == [8 * 4096, 16 * 4096, 24 * 4096]


def test_thuff_codec_on_the_card_matches_the_cpu(device):
    from tieredstorage_tpu_torch.transform import thuff

    chunks = _log_rows(3, 300_000, seed=4) + [b"", b"z" * 5000]
    frames = thuff.compress_batch(chunks, device=device)
    assert frames == thuff.compress_batch(chunks, device="cpu")
    before = _cuda.launch_counts()["huffman_decode"]
    assert thuff.decompress_batch(frames, device=device) == chunks
    assert _cuda.launch_counts()["huffman_decode"] == before + 1


def test_compressed_encrypted_rsm_round_trip_on_the_card(device, tmp_path):
    store, seg = tmp_path / "store", tmp_path / "seg"
    store.mkdir()
    seg.mkdir()
    pub, priv = generate_key_pair_pem_files(tmp_path, prefix="huff")
    chunk = 1 << 20
    log = b"".join(_log_rows(5, chunk, seed=11)) + b"tail" * 100
    files = {name: seg / f"00000000000000000000.{name}" for name in ("log", "index", "timeindex")}
    files["log"].write_bytes(log)
    files["index"].write_bytes(b"\x01" * 80)
    files["timeindex"].write_bytes(b"\x02" * 120)
    tip = metadata.TopicIdPartition(metadata.KafkaUuid(b"\x03" * 16), metadata.TopicPartition("t", 0))
    md = metadata.RemoteLogSegmentMetadata(
        remote_log_segment_id=metadata.RemoteLogSegmentId(tip, metadata.KafkaUuid(b"\x04" * 16)),
        start_offset=0, end_offset=99, segment_size_in_bytes=len(log),
    )
    sd = metadata.LogSegmentData(
        log_segment=files["log"], offset_index=files["index"], time_index=files["timeindex"],
        producer_snapshot_index=files["index"], transaction_index=None,
        leader_epoch_index=b"0\n1\n0 0\n",
    )
    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(store), "chunk.size": chunk,
        "compression.enabled": True, "compression.codec": "tpu-huff-v1",
        "encryption.enabled": True, "encryption.key.pair.id": "k",
        "encryption.key.pairs": "k",
        "encryption.key.pairs.k.public.key.file": str(pub),
        "encryption.key.pairs.k.private.key.file": str(priv),
    })
    rsm.copy_log_segment_data(md, sd)
    [log_obj] = store.rglob("*.log")
    assert log_obj.stat().st_size < 0.9 * len(log)
    before = _cuda.launch_counts()
    with rsm.fetch_log_segment(md, 0) as stream:
        assert stream.read() == log
    with rsm.fetch_log_segment(md, chunk - 10, 3 * chunk + 5) as stream:
        assert stream.read() == log[chunk - 10: 3 * chunk + 6]
    after = _cuda.launch_counts()
    for name in ("huffman_decode", "aes_ctr_keystream", "ghash_tree"):
        assert after[name] > before[name], name
    rsm.delete_log_segment_data(md)
    rsm.close()


def test_rsm_over_a_signature_verifying_s3_emulator_on_the_card(device, tmp_path):
    """The port's RSM on cuda:0 over S3 (SigV4 checked on every request):
    64 MiB copied in 5 MiB parts, fetched whole and in a range, byte for
    byte, with the GCM kernels launched on copy and fetch."""
    from tests.emulators.s3_emulator import S3Emulator

    emu = S3Emulator(credentials=("card-access", "card-secret")).start()
    try:
        rng = np.random.default_rng(21)
        log = rng.bytes(64 << 20)
        paths = {}
        for name, data in (("log", log), ("index", rng.bytes(8 * 4096)),
                           ("timeindex", rng.bytes(12 * 4096)), ("snapshot", rng.bytes(40))):
            paths[name] = tmp_path / f"00000000000000000000.{name}"
            paths[name].write_bytes(data)
        tip = metadata.TopicIdPartition(metadata.KafkaUuid(rng.bytes(16)),
                                        metadata.TopicPartition("t", 0))
        md = metadata.RemoteLogSegmentMetadata(
            remote_log_segment_id=metadata.RemoteLogSegmentId(tip, metadata.KafkaUuid(rng.bytes(16))),
            start_offset=0, end_offset=4095, segment_size_in_bytes=len(log),
        )
        sd = metadata.LogSegmentData(
            log_segment=paths["log"], offset_index=paths["index"], time_index=paths["timeindex"],
            producer_snapshot_index=paths["snapshot"], transaction_index=None,
            leader_epoch_index=b"0\n1\n0 0\n",
        )
        pub, priv = generate_key_pair_pem_files(tmp_path, prefix="s3")
        rsm = RemoteStorageManager()
        rsm.configure({
            "storage.backend.class": "tieredstorage_tpu_torch.storage.s3.S3Storage",
            "storage.s3.bucket.name": "card", "storage.s3.endpoint.url": emu.endpoint,
            "storage.aws.access.key.id": "card-access",
            "storage.aws.secret.access.key": "card-secret",
            "chunk.size": 4 << 20, "key.prefix": "s3/", "transform.device": str(device),
            "encryption.enabled": True, "encryption.key.pair.id": "k",
            "encryption.key.pairs": "k",
            "encryption.key.pairs.k.public.key.file": str(pub),
            "encryption.key.pairs.k.private.key.file": str(priv),
        })
        _cuda.reset_launch_counts()
        rsm.copy_log_segment_data(md, sd)
        with rsm.fetch_log_segment(md, 0) as stream:
            assert stream.read() == log
        with rsm.fetch_log_segment(md, (5 << 20) - 7, (9 << 20) + 3) as stream:
            assert stream.read() == log[(5 << 20) - 7: (9 << 20) + 4]
        counts = _cuda.launch_counts()
        for name in ("aes_ctr_keystream", "ghash_tree", "ghash_level1"):
            assert counts[name] > 0, name
        rsm.delete_log_segment_data(md)
        assert list(rsm._storage.list_objects("s3/")) == []
        rsm.close()
    finally:
        emu.stop()


def test_merged_flush_under_a_flaky_launch_matches_unbatched(device):
    """``device.launch:flaky=1``: the merged launch's first attempt fails
    before staging; the retry restages from the untouched packed input and
    every caller's bytes equal the unbatched decrypt's."""
    import threading

    from tieredstorage_tpu_torch.security.aes import DataKeyAndAAD
    from tieredstorage_tpu_torch.transform.api import DetransformOptions, TransformOptions
    from tieredstorage_tpu_torch.transform.batcher import WindowBatcher
    from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend
    from tieredstorage_tpu_torch.utils import faults

    rng = np.random.default_rng(63)
    enc = DataKeyAndAAD(rng.bytes(32), rng.bytes(32))
    windows = [[rng.bytes(1 << 20), rng.bytes((1 << 20) - 64 * i)] for i in range(3)]
    plain = CudaTransformBackend()
    plain.configure({})
    wires = [plain.transform(w, TransformOptions(encryption=enc)) for w in windows]
    unbatched = [plain.detransform(w, DetransformOptions(encryption=enc)) for w in wires]
    backend = CudaTransformBackend()
    backend.configure({})
    batcher = WindowBatcher(backend, wait_ms=50, launch_attempts=2, launch_backoff_s=0.0)
    batcher._inflight += 1
    backend.batcher = batcher
    plane = faults.FaultPlane.parse("device.launch:flaky=1")
    prior = faults.install(plane)
    try:
        results: list = [None] * 3
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, backend.detransform(wires[i], DetransformOptions(encryption=enc)))) for i in range(3)]
        for t in threads:
            t.start()
        with batcher._cond:
            assert batcher._cond.wait_for(
                lambda: sum(len(v) for v in batcher._buckets.values()) == 3, timeout=60)
        before = _cuda.launch_counts()["aes_ctr_keystream"]
        assert batcher.flush_now() == 1
        for t in threads:
            t.join(timeout=60)
    finally:
        faults.install(prior)
    assert results == unbatched == windows
    assert batcher.launch_retries == 1 == plane.fired[("device.launch", "flaky")]
    assert (batcher.launch_failures, batcher.launches) == (0, 1)
    assert _cuda.launch_counts()["aes_ctr_keystream"] == before + 1
    plain.close()
    backend.close()


@pytest.mark.parametrize("keep", [3, 4096 + 100], ids=["under-iv-and-tag", "short-row"])
def test_torn_chunk_fetch_on_the_card_raises_authentication_error(device, tmp_path, keep):
    """``storage.read:partial``: the chunk window is shorter than the
    manifest says. The fetch must fail on the tag, with the port's
    AuthenticationError as the cause and no CUDA error, and a fresh RSM
    then reads the chunk back."""
    from tieredstorage_tpu_torch.transform.api import AuthenticationError
    from tieredstorage_tpu_torch.utils import faults

    rng = np.random.default_rng(64)
    log = rng.bytes(3 * (64 << 10) + 77)
    paths = {}
    for name, data in (("log", log), ("index", rng.bytes(48)), ("timeindex", rng.bytes(72)),
                       ("snapshot", rng.bytes(40))):
        paths[name] = tmp_path / f"00000000000000000000.{name}"
        paths[name].write_bytes(data)
    tip = metadata.TopicIdPartition(metadata.KafkaUuid(rng.bytes(16)), metadata.TopicPartition("t", 0))
    md = metadata.RemoteLogSegmentMetadata(
        remote_log_segment_id=metadata.RemoteLogSegmentId(tip, metadata.KafkaUuid(rng.bytes(16))),
        start_offset=0, end_offset=99, segment_size_in_bytes=len(log),
    )
    sd = metadata.LogSegmentData(
        log_segment=paths["log"], offset_index=paths["index"], time_index=paths["timeindex"],
        producer_snapshot_index=paths["snapshot"], transaction_index=None,
        leader_epoch_index=b"0\n1\n0 0\n",
    )
    pub, priv = generate_key_pair_pem_files(tmp_path, prefix="torn")
    store = tmp_path / "store"
    store.mkdir()
    configs = {
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(store), "chunk.size": 64 << 10, "key.prefix": "torn/",
        "transform.device": str(device), "encryption.enabled": True,
        "encryption.key.pair.id": "k", "encryption.key.pairs": "k",
        "encryption.key.pairs.k.public.key.file": str(pub),
        "encryption.key.pairs.k.private.key.file": str(priv),
    }
    writer = RemoteStorageManager()
    writer.configure(configs)
    writer.copy_log_segment_data(md, sd)
    writer.close()
    rsm = RemoteStorageManager()
    rsm.configure({**configs, "faults.spec": [f"storage.read:partial={keep}@1"]})
    try:
        with pytest.raises(Exception) as info:
            with rsm.fetch_log_segment(md, 0, 99) as stream:
                stream.read()
        chain, cur = [], info.value
        while cur is not None and cur not in chain:
            chain.append(cur)
            cur = cur.__cause__ or cur.__context__
        assert any(isinstance(c, AuthenticationError) for c in chain)
        assert not any(isinstance(c, torch.cuda.CudaError) for c in chain)
        torch.cuda.synchronize(device)
    finally:
        faults.install(None)
        rsm.close()
    fresh = RemoteStorageManager()
    fresh.configure(configs)
    with fresh.fetch_log_segment(md, 0) as stream:
        assert stream.read() == log
    fresh.close()


def test_antientropy_arbitrates_with_crc32c_on_the_card(device):
    """Three replicas: one holds the correct `.log`, one a flipped byte,
    one none. The majority ties, so only the manifest's checksums decide,
    and their CRC32C runs on the card."""
    import base64
    import io
    import json

    from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex, chunk_index_to_json
    from tieredstorage_tpu_torch.ops import crc32c
    from tieredstorage_tpu_torch.scrub.antientropy import AntiEntropyRepairer
    from tieredstorage_tpu_torch.storage.core import ObjectKey
    from tieredstorage_tpu_torch.storage.memory import InMemoryStorage
    from tieredstorage_tpu_torch.storage.replicated import ReplicatedStorageBackend

    chunk, n = (4 << 20) + 28, 4
    rng = np.random.default_rng(65)
    log = rng.bytes(chunk * n)
    flipped = bytearray(log)
    flipped[chunk + 1000] ^= 0x01
    sums = [crc32c.crc32c_host(log[i : i + chunk]) for i in range(0, len(log), chunk)]
    manifest = json.dumps({
        "version": "1", "chunkIndex": chunk_index_to_json(FixedSizeChunkIndex(chunk, len(log), chunk, chunk)),
        "chunkChecksums": base64.b64encode(b"".join(c.to_bytes(4, "big") for c in sums)).decode(),
        "compression": False, "segmentIndexes": {},
    }).encode()
    children = []
    for name, blob in (("a", bytes(flipped)), ("b", log), ("c", None)):
        child = InMemoryStorage()
        child.configure({})
        child.upload(io.BytesIO(manifest), ObjectKey("p/s.rsm-manifest"))
        if blob is not None:
            child.upload(io.BytesIO(blob), ObjectKey("p/s.log"))
        children.append((name, child))
    rep = ReplicatedStorageBackend(children)
    seen = []
    real = crc32c.crc32c_chunks

    def counted(data, dev):
        seen.append(torch.device(dev))
        return real(data, dev)

    crc32c.crc32c_chunks = counted
    try:
        report = AntiEntropyRepairer(rep, prefix="p/").run_once()
    finally:
        crc32c.crc32c_chunks = real
    assert (report.missing_copies, report.divergent_keys, report.repairs) == (1, 1, 2)
    assert seen and all(d.type == "cuda" for d in seen)
    for _, child in children:
        assert child.object("p/s.log") == log
    assert AntiEntropyRepairer(rep, prefix="p/", device=device).run_once().in_sync
    rep.close()
