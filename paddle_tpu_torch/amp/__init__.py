"""AMP (so far the op registry's hook, ``auto_cast``)."""
from .auto_cast import auto_cast, amp_guard  # noqa: F401
