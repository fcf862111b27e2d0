"""Host-side C++ sources of the port, shipped as package data.

``tile_loader.cpp`` is the multithreaded TIFF pair decoder (the port's own
copy of crosstalk_tpu/native/tile_loader.cpp). ``ops/_build.py`` compiles it
with g++ at first use and ``data/native_loader.py`` binds it with ctypes.
"""
