"""The plain reference that decides ``correct``: float64 PyTorch and NumPy,
independent of the program (it imports neither the port nor JAX) and fed
only the raw map image, the configuration's numbers and what the program
printed into its logs."""
