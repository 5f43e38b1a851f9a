"""Multi-GPU rendering (``sharding``): the frame's bands over a mesh of
devices, and frame seeds over its second axis."""
