"""Transform/detransform pipeline behind the pluggable backend seam.

`CudaTransformBackend` (transform/cuda.py) is the default backend: whole
windows of chunks go to the device as one packed buffer and come back as
`output || tag` rows. `NativeTransformBackend` (transform/native_backend.py,
the C++ host library) and `CpuTransformBackend` (transform/cpu.py, the JAX
package's default and wire oracle) are the host backends. The device codecs
are transform/thuff.py and transform/lzhuff.py.
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
