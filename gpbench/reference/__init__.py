"""The benchmark's plain reference: straightforward PyTorch, in float64.

Nothing here imports the package under test. Each function takes the
inputs the benchmark made (data, starts, random draws) and works out
again whatever the program derives from them. Every function takes a
`mode`: "f64" is the reference; "tf32" is the control, the same
arithmetic in float32 with every matrix product's operands rounded to
TF32 (`precision.py`), which has to come out as not correct.
"""
