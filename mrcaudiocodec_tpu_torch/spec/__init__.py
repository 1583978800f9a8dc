"""The normative NumPy spec codec, the port's own copy.

`codec.encode(x, cfg)` and `codec.decode(data)` define the MRC1 format bit
for bit, as the JAX package's `spec/` does: these modules are copies of
it, on the port's `config`, `tables`, `utils/bits` and `bitstream`, with
the NumPy paths of `xmath` and `xpsy` in `xmath_np` and `xpsy_np`. They
import numpy only, never torch: the spec is the yardstick the port's
torch codec is held to (`models.codec` == `spec.codec`, byte for byte).
tests/test_torch_spec.py holds every copy bitwise equal to the JAX
package's spec.
"""
