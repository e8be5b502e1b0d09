"""C++ host sources (the JPEG decoder), compiled at first use by ``data/native.py``."""
