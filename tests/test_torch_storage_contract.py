"""The storage contract over every backend of the port.

The cases of tests/storage_contract.py, copied with the port's exception
types (that suite raises with the JAX package's) and run over the port's
memory, filesystem, S3, GCS, Azure and replicated backends. The cloud
backends talk to the in-repo emulators: S3 with every request's SigV4
signature checked, Azure with every request's SharedKey checked.
"""

from __future__ import annotations

import io

import pytest

from tests.emulators.azure_emulator import AzureEmulator
from tests.emulators.gcs_emulator import GcsEmulator
from tests.emulators.s3_emulator import S3Emulator
from tieredstorage_tpu_torch.storage.azure import AzureBlobStorage
from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    load_backend_class,
)
from tieredstorage_tpu_torch.storage.filesystem import FileSystemStorage
from tieredstorage_tpu_torch.storage.gcs import GcsStorage
from tieredstorage_tpu_torch.storage.memory import InMemoryStorage
from tieredstorage_tpu_torch.storage.replicated import ReplicatedStorageBackend
from tieredstorage_tpu_torch.storage.s3 import S3Storage

KEY = ObjectKey("topic/partition/00000000000000000000-abc.log")
S3_CREDENTIALS = ("test-access", "test-secret")
AZURE_ACCOUNT = "devstoreaccount1"
AZURE_KEY = "Eby8vdM02xNOcqFlqUwJPLlmEtlCDXJ1OUzFT50uSRZ6IFsuFq2UVErCz4I6tq/K1SZFPTOtr/KBHBeksoGMGw=="


@pytest.fixture(scope="module")
def emulators():
    emus = {
        "s3": S3Emulator(credentials=S3_CREDENTIALS).start(),
        "gcs": GcsEmulator().start(),
        "azure": AzureEmulator(account=AZURE_ACCOUNT, account_key=AZURE_KEY).start(),
    }
    yield emus
    for emu in emus.values():
        emu.stop()


def _clear(emulators) -> None:
    s3, gcs, azure = emulators["s3"].state, emulators["gcs"].state, emulators["azure"].state
    with s3.lock:
        s3.objects.clear()
        s3.uploads.clear()
        s3.upload_keys.clear()
    with gcs.lock:
        gcs.objects.clear()
        gcs.sessions.clear()
    with azure.lock:
        azure.blobs.clear()
        azure.blocks.clear()


def s3_configs(endpoint: str) -> dict:
    return {
        "s3.bucket.name": "test-bucket",
        "s3.region": "us-east-1",
        "s3.endpoint.url": endpoint,
        "s3.path.style.access.enabled": True,
        "aws.access.key.id": S3_CREDENTIALS[0],
        "aws.secret.access.key": S3_CREDENTIALS[1],
    }


def gcs_configs(endpoint: str) -> dict:
    return {"gcs.bucket.name": "test-bucket", "gcs.endpoint.url": endpoint,
            "gcs.credentials.default": True}


def azure_configs(endpoint: str) -> dict:
    return {"azure.account.name": AZURE_ACCOUNT, "azure.account.key": AZURE_KEY,
            "azure.container.name": "test-container", "azure.endpoint.url": endpoint}


def make_backend(kind: str, emulators, tmp_path):
    """A configured port backend of `kind`, loaded by class path as the RSM's
    `storage.backend.class` loads it."""
    paths = {
        "memory": "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
        "filesystem": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "s3": "tieredstorage_tpu_torch.storage.s3:S3Storage",
        "gcs": "tieredstorage_tpu_torch.storage.gcs:GcsStorage",
        "azure": "tieredstorage_tpu_torch.storage.azure:AzureBlobStorage",
        "replicated": "tieredstorage_tpu_torch.storage.replicated.ReplicatedStorageBackend",
    }
    configs = {
        "memory": {},
        "filesystem": {"root": str(tmp_path / "fs"), "overwrite.enabled": True},
        "s3": s3_configs(emulators["s3"].endpoint),
        "gcs": gcs_configs(emulators["gcs"].endpoint),
        "azure": azure_configs(emulators["azure"].endpoint),
        # Heterogeneous children: one in memory, one on the filesystem.
        "replicated": {
            "replication.replicas": "mem,fs",
            "replication.replica.mem.backend.class":
                "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
            "replication.replica.fs.backend.class":
                "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
            "replication.replica.fs.root": str(tmp_path / "replica-fs"),
            "replication.replica.fs.overwrite.enabled": True,
            "replication.probe.interval.ms": None,
        },
    }[kind]
    if kind == "filesystem":
        (tmp_path / "fs").mkdir()
    if kind == "replicated":
        (tmp_path / "replica-fs").mkdir()
    backend = load_backend_class(paths[kind])()
    backend.configure(configs)
    return backend


KINDS = ["memory", "filesystem", "s3", "gcs", "azure", "replicated"]
EXPECTED_TYPES = {
    "memory": InMemoryStorage, "filesystem": FileSystemStorage, "s3": S3Storage,
    "gcs": GcsStorage, "azure": AzureBlobStorage, "replicated": ReplicatedStorageBackend,
}


@pytest.fixture(params=KINDS)
def backend(request, emulators, tmp_path):
    _clear(emulators)
    b = make_backend(request.param, emulators, tmp_path)
    assert isinstance(b, EXPECTED_TYPES[request.param])
    yield b
    if hasattr(b, "close"):
        b.close()


class TestStorageContract:
    def test_upload_returns_size_and_fetch_round_trips(self, backend):
        data = b"some file content"
        size = backend.upload(io.BytesIO(data), KEY)
        assert size == len(data)
        with backend.fetch(KEY) as s:
            assert s.read() == data

    def test_upload_empty_object(self, backend):
        assert backend.upload(io.BytesIO(b""), KEY) == 0
        with backend.fetch(KEY) as s:
            assert s.read() == b""

    def test_fetch_full_range(self, backend):
        data = b"0123456789"
        backend.upload(io.BytesIO(data), KEY)
        with backend.fetch(KEY, BytesRange.of(0, len(data) - 1)) as s:
            assert s.read() == data

    def test_fetch_middle_range(self, backend):
        backend.upload(io.BytesIO(b"0123456789"), KEY)
        with backend.fetch(KEY, BytesRange.of(2, 5)) as s:
            assert s.read() == b"2345"

    def test_fetch_single_byte(self, backend):
        backend.upload(io.BytesIO(b"0123456789"), KEY)
        with backend.fetch(KEY, BytesRange.of(3, 3)) as s:
            assert s.read() == b"3"

    def test_fetch_range_overrunning_end_returns_suffix(self, backend):
        backend.upload(io.BytesIO(b"0123456789"), KEY)
        with backend.fetch(KEY, BytesRange.of(7, 100)) as s:
            assert s.read() == b"789"

    def test_fetch_range_starting_at_size_is_invalid(self, backend):
        backend.upload(io.BytesIO(b"0123456789"), KEY)
        with pytest.raises(InvalidRangeException):
            backend.fetch(KEY, BytesRange.of(10, 20))

    def test_fetch_range_far_beyond_size_is_invalid(self, backend):
        backend.upload(io.BytesIO(b"0123456789"), KEY)
        with pytest.raises(InvalidRangeException):
            backend.fetch(KEY, BytesRange.of(1000, 2000))

    def test_fetch_nonexistent_key(self, backend):
        with pytest.raises(KeyNotFoundException):
            backend.fetch(ObjectKey("no/such/key"))

    def test_fetch_nonexistent_key_ranged(self, backend):
        with pytest.raises(KeyNotFoundException):
            backend.fetch(ObjectKey("no/such/key"), BytesRange.of(0, 1))

    def test_delete_removes_object(self, backend):
        backend.upload(io.BytesIO(b"x"), KEY)
        backend.delete(KEY)
        with pytest.raises(KeyNotFoundException):
            backend.fetch(KEY)

    def test_delete_nonexistent_is_noop(self, backend):
        backend.delete(ObjectKey("no/such/key"))

    def test_delete_all(self, backend):
        keys = [ObjectKey(f"k/{i}") for i in range(3)]
        for k in keys:
            backend.upload(io.BytesIO(b"v"), k)
        backend.delete_all(keys)
        for k in keys:
            with pytest.raises(KeyNotFoundException):
                backend.fetch(k)

    def test_retried_delete_of_half_deleted_triple_succeeds(self, backend):
        """A retried segment delete sees a half-deleted triple: re-deleting
        keys that are already gone is a no-op, per key and batched."""
        stem = "topic/partition/00000000000000000042-abc"
        triple = [ObjectKey(stem + suffix)
                  for suffix in (".log", ".indexes", ".rsm-manifest")]
        for k in triple:
            backend.upload(io.BytesIO(b"v"), k)
        backend.delete(triple[1])
        backend.delete_all(triple)
        for k in triple:
            with pytest.raises(KeyNotFoundException):
                backend.fetch(k)
        backend.delete_all(triple)
        for k in triple:
            backend.delete(k)

    def test_overwrite_same_key(self, backend):
        backend.upload(io.BytesIO(b"first"), KEY)
        backend.upload(io.BytesIO(b"second!"), KEY)
        with backend.fetch(KEY) as s:
            assert s.read() == b"second!"

    def test_large_object_round_trip(self, backend):
        data = bytes(range(256)) * 4096  # 1 MiB
        backend.upload(io.BytesIO(data), KEY)
        with backend.fetch(KEY) as s:
            assert s.read() == data
        with backend.fetch(KEY, BytesRange.of_from_position_and_size(100_000, 5000)) as s:
            assert s.read() == data[100_000:105_000]

    def test_list_objects_returns_all_keys_sorted(self, backend):
        keys = ["b/2", "a/1", "b/1", "a/10"]
        for k in keys:
            backend.upload(io.BytesIO(b"v"), ObjectKey(k))
        assert [k.value for k in backend.list_objects()] == sorted(keys)

    def test_list_objects_prefix_filters(self, backend):
        for k in ("seg/0001.log", "seg/0001.rsm-manifest", "other/x"):
            backend.upload(io.BytesIO(b"v"), ObjectKey(k))
        assert [k.value for k in backend.list_objects("seg/")] == [
            "seg/0001.log", "seg/0001.rsm-manifest",
        ]
        assert [k.value for k in backend.list_objects("seg/0001.l")] == ["seg/0001.log"]

    def test_list_objects_empty_listing_is_not_an_error(self, backend):
        assert list(backend.list_objects()) == []
        backend.upload(io.BytesIO(b"v"), KEY)
        assert list(backend.list_objects("no/such/prefix")) == []

    def test_list_objects_reflects_deletes(self, backend):
        a, b = ObjectKey("list/a"), ObjectKey("list/b")
        backend.upload(io.BytesIO(b"v"), a)
        backend.upload(io.BytesIO(b"v"), b)
        backend.delete(a)
        assert [k.value for k in backend.list_objects("list/")] == ["list/b"]


@pytest.mark.parametrize("kind", ["memory", "replicated"])
def test_list_objects_beyond_one_page(kind, emulators, tmp_path):
    """The pagination section: 1050 keys list in order across page
    boundaries (the cloud backends' pages are tested against the emulators'
    1000-key pages in test_torch_storage_protocol.py)."""
    backend = make_backend(kind, emulators, tmp_path)
    keys = [f"page/{i:06d}" for i in range(1050)]
    for k in keys + ["other/x"]:
        backend.upload(io.BytesIO(b""), ObjectKey(k))
    assert [k.value for k in backend.list_objects("page/")] == keys
    assert len(list(backend.list_objects())) == 1051
