"""Plain PyTorch and NumPy reference of the OCR pipeline the benchmark
drives: DBNet, the DBNet postprocessor's quads, the page and line crops,
PARSeq.  Written from the published architecture (upstream YomiToku's
configs and the reference checkpoints' state_dict layout), in float32,
with no kernel, cache or batching of the program under test.  It imports
nothing of that program.

Every matmul and convolution goes through ``Precision``: float32 with
TF32 off for the reference, or float8 (e4m3, scaled per row / per output
channel) for the lower-precision control that the benchmark's correctness
limits are held against.
"""
