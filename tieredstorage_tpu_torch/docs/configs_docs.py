"""Generate docs/torch/configs.rst from this package's live ConfigDefs.

Counterpart of tieredstorage_tpu/docs/configs_docs.py: a section per config
class, keys rendered Kafka-toRst-style — name, doc, type/default/valid-
values/importance bullets, sorted by importance then name. The transform
backend's section is this package's CUDA backend (transform/cuda.py).

    python -m tieredstorage_tpu_torch.docs.configs_docs   # writes the file
"""

from __future__ import annotations

from tieredstorage_tpu_torch.config.configdef import NO_DEFAULT, ConfigDef, ConfigKey

_IMPORTANCE_ORDER = {"high": 0, "medium": 1, "low": 2}


def _default_repr(key: ConfigKey) -> str:
    if key.default is NO_DEFAULT:
        return ""
    if key.default is None:
        return "null"
    if isinstance(key.default, bool):
        return "true" if key.default else "false"
    if isinstance(key.default, list):
        return ",".join(map(str, key.default)) if key.default else '""'
    return str(key.default)


def render_config_def(definition: ConfigDef, *, prefix: str = "") -> str:
    lines: list[str] = []
    keys = sorted(
        definition.keys.values(),
        key=lambda k: (_IMPORTANCE_ORDER.get(k.importance, 3), k.name),
    )
    for key in keys:
        lines.append(f"``{prefix}{key.name}``")
        doc = key.doc or ""
        for doc_line in doc.split("\n"):
            lines.append(f"  {doc_line}".rstrip())
        lines.append("")
        lines.append(f"  * Type: {key.type}")
        # Real validator ranges ("[1,...,1073741823]"); bare "required" only
        # when no validator describes itself.
        desc = getattr(key.validator, "description", None)
        if not key.required:
            lines.append(f"  * Default: {_default_repr(key)}")
        if desc:
            lines.append(f"  * Valid Values: {desc}")
        elif key.required:
            lines.append("  * Valid Values: required")
        lines.append(f"  * Importance: {key.importance}")
        lines.append("")
    return "\n".join(lines)


def _section(title: str, underline: str = "-") -> list[str]:
    return [title, underline * len(title), ""]


def generate() -> str:
    # Imports inside the generator keep module import light.
    from tieredstorage_tpu_torch.config import cache_config, rsm_config
    from tieredstorage_tpu_torch.storage.azure.config import AzureBlobStorageConfig
    from tieredstorage_tpu_torch.storage.gcs.config import GcsStorageConfig
    from tieredstorage_tpu_torch.storage.proxy import ProxyConfig
    from tieredstorage_tpu_torch.storage.s3.config import S3StorageConfig

    out: list[str] = []
    out += _section("Tiered Storage CUDA configs", "=")
    out += _section("RemoteStorageManagerConfig")
    out.append(render_config_def(rsm_config._base_def()))
    out += _section("CudaTransformBackendConfig (prefix: transform.)")
    from tieredstorage_tpu_torch.transform import cuda as transform_cuda

    out.extend([
        "Keys under the ``transform.`` prefix reach the configured transform",
        "backend's ``configure()`` (``transform_configs()`` in",
        "``config/rsm_config.py``); these are the keys the CUDA backend reads.",
        "",
    ])
    out.append(
        render_config_def(transform_cuda._definition(), prefix="transform.")
    )
    from tieredstorage_tpu_torch.fetch.index_cache import MemorySegmentIndexesCache
    from tieredstorage_tpu_torch.fetch.manifest_cache import MemorySegmentManifestCache

    out += _section("ChunkCacheConfig (prefix: fetch.chunk.cache.)")
    out.append(
        render_config_def(cache_config._cache_def())
        + "\n"
        + render_config_def(cache_config._chunk_cache_extra())
    )
    out += _section("DiskChunkCacheConfig (additional keys)")
    out.append(render_config_def(cache_config._disk_cache_extra()))
    out += _section("DeviceHotCacheConfig")
    from tieredstorage_tpu_torch.fetch.cache import device_hot

    out.extend([
        "The device-resident hot-window cache tier (decrypt once, serve",
        "many): top-level keys read by the ChunkManagerFactory. The tier",
        "sits between the chunk cache and the fleet peer tier and is",
        "disabled unless ``cache.device.bytes`` is set.",
        "",
    ])
    out.append(render_config_def(device_hot._definition()))
    out += _section("ReadaheadConfig")
    from tieredstorage_tpu_torch.fetch import readahead

    out.extend([
        "The predictive sequential-readahead tier (speculate future",
        "windows, pre-admit verified plaintext): top-level keys read by",
        "the ChunkManagerFactory. The tier wraps the fetch chain outermost",
        "and is disabled unless ``readahead.enabled`` is true; see",
        "``docs/readahead.rst`` for the detector state machine and budget",
        "math.",
        "",
    ])
    out.append(render_config_def(readahead._definition()))
    out += _section("SegmentManifestCacheConfig (prefix: fetch.manifest.cache.)")
    out.append(
        render_config_def(
            cache_config._cache_def(
                size_default=MemorySegmentManifestCache.DEFAULT_MAX_SIZE,
                retention_ms_default=MemorySegmentManifestCache.DEFAULT_RETENTION_MS,
            )
        )
    )
    out += _section("SegmentIndexesCacheConfig (prefix: fetch.indexes.cache.)")
    out.append(
        render_config_def(
            cache_config._cache_def(
                size_default=MemorySegmentIndexesCache.DEFAULT_MAX_SIZE_BYTES
            )
        )
    )
    out += _section("ReplicatedStorageBackendConfig (prefix: storage.)")
    from tieredstorage_tpu_torch.storage import replicated

    out.extend([
        "Each name in ``replication.replicas`` additionally defines the",
        "dynamic key family ``replication.replica.<name>.backend.class``",
        "plus that backend's own keys under the",
        "``replication.replica.<name>.`` prefix (passed through with the",
        "prefix stripped).",
        "",
    ])
    out.append(render_config_def(replicated._definition()))
    out += _section("S3StorageConfig (prefix: storage.)")
    out.append(render_config_def(S3StorageConfig.DEFINITION))
    out += _section("GcsStorageConfig (prefix: storage.)")
    out.append(render_config_def(GcsStorageConfig.DEFINITION))
    out += _section("AzureBlobStorageConfig (prefix: storage.)")
    out.append(render_config_def(AzureBlobStorageConfig.DEFINITION))
    out += _section("ProxyConfig (prefix: storage.proxy.)")
    out.append(render_config_def(ProxyConfig.DEFINITION))
    return "\n".join(out).rstrip() + "\n"


#: Where `main` writes the document, relative to the repository root.
OUTPUT = "docs/torch/configs.rst"


def main() -> None:
    from pathlib import Path

    path = Path(__file__).resolve().parents[2] / OUTPUT
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(generate())
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
