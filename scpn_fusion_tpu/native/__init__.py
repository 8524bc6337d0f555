"""Native C++ host runtime (CPU lane + parity fixture for the SOR sweep)."""

from scpn_fusion_tpu.native.runtime import (
    NativeGSSolver,
    build_library,
    get_runtime,
    is_available,
)

__all__ = ["NativeGSSolver", "build_library", "get_runtime", "is_available"]
