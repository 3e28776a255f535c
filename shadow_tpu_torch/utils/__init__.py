"""Host-side utilities: window-boundary checkpoint and resume."""
