"""The benchmark of the PyTorch and CUDA port (`tieredstorage_tpu_torch`)."""
