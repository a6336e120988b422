"""Host-side data code: the port's own copies of the JAX package's ``data``
modules (``preprocessing``, ``image_io``, ``homography``, ``dataset``,
``augment``, ``colmap_model``), which load no JAX. Import the modules
themselves; this package re-exports nothing."""
