"""A frozen copy of the port's host preprocessing (`preprocess/`,
`utils/rng.py`), the reference's own: the benchmark's yardstick may not
change when the program's preprocessing does. The row fingerprint is the
pure-Python hash (the port's native twin is bit-exact with it)."""
