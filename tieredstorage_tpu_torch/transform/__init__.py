"""Transform/detransform pipeline behind the pluggable backend seam.

`CudaTransformBackend` (transform/cuda.py) is the only backend of this
package: whole windows of chunks go to the device as one packed buffer and
come back as `output || tag` rows.
"""

from tieredstorage_tpu_torch.transform.api import (
    DetransformOptions,
    TransformBackend,
    TransformOptions,
)
from tieredstorage_tpu_torch.transform.pipeline import (
    SegmentTransformation,
    detransform_chunks,
)

__all__ = [
    "DetransformOptions",
    "SegmentTransformation",
    "TransformBackend",
    "TransformOptions",
    "detransform_chunks",
]
