"""Host-side pack for the general unstructured ``AIJ`` operator.

``aij_pack`` compiles an arbitrary sparsity pattern into a Clos-routed
gather program (``clos_route`` colours its stages); ``aij_pack.aij_mv_jnp``
applies it in plain ``jax.numpy``.  Every device operation of the
framework is plain ``jax.numpy``/``lax`` left to XLA: no hand-written
kernels ship here.
"""
