"""CUDA C++ kernel sources, compiled at first use by the ops that launch them."""
