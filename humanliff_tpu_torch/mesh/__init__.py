"""Marching cubes (ctypes binding of ``native/``) and mesh writers."""
