"""The frozen yardstick of the kernels' layer."""
