"""Host acceleration structures of the port: the SAH BVH builders (numpy
and native C++), the 4-wide and arity-2 collapses, and the page cut of
the paged kernels."""
