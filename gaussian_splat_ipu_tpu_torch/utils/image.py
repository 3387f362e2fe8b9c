"""PNG encode/decode: the reference's jax-free stdlib codec, shared."""

from gaussian_splat_ipu_tpu.utils.image import (  # noqa: F401  (re-export)
    decode_png,
    encode_png,
    to_uint8,
    write_png,
)
