"""Azure Blob storage backend (Blob REST API over stdlib HTTP, no SDK).

Counterpart of tieredstorage_tpu/storage/azure/.

Reference module: storage/azure (AzureBlobStorage.java,
AzureBlobStorageConfig.java, MetricCollector.java).
"""

from tieredstorage_tpu_torch.storage.azure.config import AzureBlobStorageConfig
from tieredstorage_tpu_torch.storage.azure.storage import AzureBlobStorage

__all__ = ["AzureBlobStorage", "AzureBlobStorageConfig"]
