"""Host-side data helpers of the port (copies; no JAX)."""
