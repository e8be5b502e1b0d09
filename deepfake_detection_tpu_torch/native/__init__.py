"""C++ host sources (the JPEG decoder, the image ops and their one worker
pool), built into one library at first use by ``data/native.py``."""
