"""The port's shim wire against the JAX package's, byte for byte.

Seeded metadata, copy sections, fetch tails and index names go through
both packages' `shimwire` encoders and decoders, and through the
independent `JavaShimEncoder` of tests/test_sidecar_http_gateway.py (a
field-by-field mirror of the Java shim's writers). Every frame must be the
same bytes, and every decoder must read the other's frames back into the
same fields; malformed frames fail with the same error and message.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from tests.test_sidecar_http_gateway import JavaShimEncoder
from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.sidecar import shimwire as jax_shimwire
from tieredstorage_tpu.utils import deadline as jax_deadline
from tieredstorage_tpu.utils.tracing import Tracer as JaxTracer
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.sidecar import shimwire
from tieredstorage_tpu_torch.utils import deadline
from tieredstorage_tpu_torch.utils.tracing import Tracer

SEEDS = range(6)


def _fields(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n_epochs = int(rng.integers(0, 5))
    topic = "".join(rng.choice(list("abcxyzøé-_."), size=int(rng.integers(1, 40))))
    return {
        "topic_id": bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
        "segment_id": bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
        "topic": topic,
        "partition": int(rng.integers(0, 2**31 - 1)),
        "start": int(rng.integers(0, 2**62)),
        "end": int(rng.integers(0, 2**62)),
        "max_ts": int(rng.integers(-1, 2**40)),
        "broker": int(rng.integers(-1, 2**31 - 1)),
        "event_ts": int(rng.integers(-1, 2**40)),
        "epochs": {int(e): int(rng.integers(0, 2**62)) for e in rng.integers(0, 2**31 - 1, n_epochs)},
        "size": int(rng.integers(0, 2**40)),
        "custom": None if seed % 3 == 0 else rng.bytes(int(rng.integers(0, 64))),
    }


def _md(mod, f: dict):
    tip = mod.TopicIdPartition(mod.KafkaUuid(f["topic_id"]), mod.TopicPartition(f["topic"], f["partition"]))
    return mod.RemoteLogSegmentMetadata(
        remote_log_segment_id=mod.RemoteLogSegmentId(tip, mod.KafkaUuid(f["segment_id"])),
        start_offset=f["start"], end_offset=f["end"], max_timestamp_ms=f["max_ts"],
        broker_id=f["broker"], event_timestamp_ms=f["event_ts"],
        segment_leader_epochs=dict(f["epochs"]), segment_size_in_bytes=f["size"],
        custom_metadata=f["custom"],
    )


def _java_md(f: dict) -> bytes:
    """The Java mirror writes the module's fixed topic and segment ids."""
    return JavaShimEncoder.metadata(
        topic=f["topic"], partition=f["partition"], start_offset=f["start"],
        end_offset=f["end"], max_ts=f["max_ts"], broker_id=f["broker"],
        event_ts=f["event_ts"], epochs=f["epochs"] or {}, size=f["size"], custom=f["custom"],
    )


def _java_fields(f: dict) -> dict:
    from tests.test_sidecar_http_gateway import SEGMENT_ID, TOPIC_ID

    return {**f, "topic_id": TOPIC_ID.raw, "segment_id": SEGMENT_ID.raw}


@pytest.mark.parametrize("seed", SEEDS)
def test_metadata_frames_equal_jax_and_the_java_mirror(seed):
    f = _fields(seed)
    port = shimwire.encode_metadata(_md(metadata, f))
    assert port == jax_shimwire.encode_metadata(_md(jax_metadata, f))
    jf = _java_fields(f)
    assert shimwire.encode_metadata(_md(metadata, jf)) == _java_md(f)


@pytest.mark.parametrize("seed", SEEDS)
def test_metadata_decodes_across_packages(seed):
    f = _fields(seed)
    port_frame = shimwire.encode_metadata(_md(metadata, f))
    jax_frame = jax_shimwire.encode_metadata(_md(jax_metadata, f))
    from_jax = shimwire.decode_metadata(io.BytesIO(jax_frame))
    from_port = jax_shimwire.decode_metadata(io.BytesIO(port_frame))
    assert from_jax == _md(metadata, f)
    assert from_port == _md(jax_metadata, f)
    # Decoding leaves the stream just past the frame.
    buf = io.BytesIO(port_frame + b"tail")
    shimwire.decode_metadata(buf)
    assert buf.read() == b"tail"


@pytest.mark.parametrize("seed", SEEDS)
def test_copy_sections_equal_jax_and_decode_to_files(seed, tmp_path):
    rng = np.random.default_rng(100 + seed)
    sections = {
        name: (None if rng.random() < 0.3 else rng.bytes(int(rng.integers(0, 3 << 20))))
        for name in shimwire.COPY_SECTIONS
    }
    port = shimwire.encode_sections(sections)
    assert port == jax_shimwire.encode_sections(sections)
    assert port == b"".join(JavaShimEncoder.section(sections[n]) for n in shimwire.COPY_SECTIONS)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = shimwire.decode_sections_to_dir(io.BytesIO(port), tmp_path / "port")
    want = jax_shimwire.decode_sections_to_dir(io.BytesIO(port), tmp_path / "jax")
    for name in shimwire.COPY_SECTIONS:
        if sections[name] is None:
            assert got[name] is None and want[name] is None
        else:
            assert got[name].read_bytes() == want[name].read_bytes() == sections[name]


@pytest.mark.parametrize("start,end", [(0, None), (5, 99), (2**62, 2**62 + 7), (0, 0)])
def test_fetch_tail_and_index_type_frames(start, end):
    frame = shimwire.encode_fetch_tail(start, end)
    assert frame == jax_shimwire.encode_fetch_tail(start, end)
    assert frame == (JavaShimEncoder.fetch_tail(start) if end is None
                     else JavaShimEncoder.fetch_tail(start, end))
    assert shimwire.decode_fetch_tail(io.BytesIO(frame)) == (start, end)
    assert jax_shimwire.decode_fetch_tail(io.BytesIO(frame)) == (start, end)


@pytest.mark.parametrize("name", ["OFFSET", "TIMESTAMP", "PRODUCER_SNAPSHOT",
                                  "LEADER_EPOCH", "TRANSACTION", "BÖGUS"])
def test_index_type_frames(name):
    frame = shimwire.encode_index_type(name)
    assert frame == jax_shimwire.encode_index_type(name) == JavaShimEncoder.index_tail(name)
    assert shimwire.decode_index_type(io.BytesIO(frame)) == name


MALFORMED = {
    "empty": b"",
    "bad version": b"\x02" + b"\x00" * 80,
    "truncated ids": b"\x01" + b"\x00" * 10,
    "negative epochs": (
        b"\x01" + b"\x00" * 32 + b"\x00\x01t" + b"\x00" * 40 + b"\xff\xff\xff\xff"
    ),
    "truncated custom": JavaShimEncoder.metadata(custom=b"abcdef")[:-3],
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_metadata_fails_as_jax(case):
    raw = MALFORMED[case]
    with pytest.raises(shimwire.ShimWireError) as port_err:
        shimwire.decode_metadata(io.BytesIO(raw))
    with pytest.raises(jax_shimwire.ShimWireError) as jax_err:
        jax_shimwire.decode_metadata(io.BytesIO(raw))
    assert str(port_err.value) == str(jax_err.value)
    assert isinstance(port_err.value, ValueError)


def test_oversized_and_truncated_sections_fail_as_jax(tmp_path):
    over = b"\x01" + (5 << 30).to_bytes(8, "big")
    short = b"\x01" + (10).to_bytes(8, "big") + b"abc"
    for raw in (over, short):
        errors = []
        for mod, sub in ((shimwire, "p"), (jax_shimwire, "j")):
            (tmp_path / sub).mkdir(exist_ok=True)
            with pytest.raises(mod.ShimWireError) as err:
                mod.decode_sections_to_dir(io.BytesIO(raw), tmp_path / sub)
            errors.append(str(err.value))
        assert errors[0] == errors[1]


def test_request_headers_equal_jax():
    """trace + deadline headers: the same names, and the same values for
    the same trace context and budget."""
    assert shimwire.TRACEPARENT_HEADER == jax_shimwire.TRACEPARENT_HEADER
    assert shimwire.DEADLINE_HEADER == jax_shimwire.DEADLINE_HEADER
    assert shimwire.request_headers(None) == {} == jax_shimwire.request_headers(None)
    parent = "00-0123456789abcdef0123456789abcdef-0123456789abcdef-01"
    port_tracer, jax_tracer = Tracer(enabled=True), JaxTracer(enabled=True)
    with port_tracer.continue_trace(parent), port_tracer.span("client.fetch"):
        port = shimwire.trace_headers(port_tracer)
    with jax_tracer.continue_trace(parent), jax_tracer.span("client.fetch"):
        jax = jax_shimwire.trace_headers(jax_tracer)
    assert set(port) == set(jax) == {"traceparent"}
    assert port["traceparent"].split("-")[1] == jax["traceparent"].split("-")[1] == parent.split("-")[1]
    with deadline.deadline_scope(deadline.Deadline.after(60.0)):
        port_ms = int(shimwire.deadline_headers()[shimwire.DEADLINE_HEADER])
    with jax_deadline.deadline_scope(jax_deadline.Deadline.after(60.0)):
        jax_ms = int(jax_shimwire.deadline_headers()[jax_shimwire.DEADLINE_HEADER])
    assert 59_000 <= port_ms <= 60_000 and 59_000 <= jax_ms <= 60_000
