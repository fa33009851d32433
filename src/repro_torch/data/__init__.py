"""Data: grid-structure probes (host side) and the synthetic and tidal
records of the paper."""
