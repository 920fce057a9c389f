"""GCS storage backend (JSON API over stdlib HTTP, no SDK).

Counterpart of tieredstorage_tpu/storage/gcs/.

Reference module: storage/gcs (GcsStorage.java, GcsStorageConfig.java,
CredentialsBuilder.java, MetricCollector.java).
"""

from tieredstorage_tpu_torch.storage.gcs.config import GcsStorageConfig
from tieredstorage_tpu_torch.storage.gcs.storage import GcsStorage

__all__ = ["GcsStorage", "GcsStorageConfig"]
