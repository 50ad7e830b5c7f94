"""The plain float64 reference: voxel map, plane factor and LM, in
NumPy and plain PyTorch, importing nothing of the program."""
