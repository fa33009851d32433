"""Host-side data probes."""
