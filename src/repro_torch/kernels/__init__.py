"""Hand-written Hopper kernels (``csrc/``), their wrappers, their plain
versions (``ref``) and the device-dispatching ``ops`` layer."""
