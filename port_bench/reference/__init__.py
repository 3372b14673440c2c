"""The plain float32 reference of the benchmark's comparisons: the
DeepSDF decoder read from its weights file, a sphere trace and the
surface normals, in plain PyTorch. It imports nothing of the port and
takes nothing the port has made; ``control`` runs the same code at a
lower precision, the comparison's control."""
