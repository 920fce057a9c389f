"""Typed configuration, cut to the keys this package implements."""

from tieredstorage_tpu_torch.config.configdef import ConfigDef, ConfigException, ConfigKey
from tieredstorage_tpu_torch.config.rsm_config import RemoteStorageManagerConfig

__all__ = ["ConfigDef", "ConfigException", "ConfigKey", "RemoteStorageManagerConfig"]
