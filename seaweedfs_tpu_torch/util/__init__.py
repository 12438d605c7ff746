"""Small helpers of the port's control plane."""
