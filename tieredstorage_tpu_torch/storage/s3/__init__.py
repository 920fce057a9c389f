"""S3 storage backend (REST + SigV4, no SDK).

Counterpart of tieredstorage_tpu/storage/s3/.

Reference module: storage/s3 (S3Storage.java, S3StorageConfig.java,
S3ClientBuilder.java, S3MultiPartOutputStream.java, MetricCollector.java).
"""

from tieredstorage_tpu_torch.storage.s3.config import S3StorageConfig
from tieredstorage_tpu_torch.storage.s3.storage import S3Storage

__all__ = ["S3Storage", "S3StorageConfig"]
