"""Documentation generators of this package.

Counterpart of tieredstorage_tpu/docs: RST printed from the live ConfigDefs
and metric registries, so the docs can never drift from the code. Each
generator's `main` writes its file under docs/torch/:

    python -m tieredstorage_tpu_torch.docs.configs_docs   # docs/torch/configs.rst
    python -m tieredstorage_tpu_torch.docs.metrics_docs   # docs/torch/metrics.rst

The static analysis (`config-drift`) regenerates both and fails on any
difference from the committed files.
"""
