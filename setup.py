"""Build the native host-kernel extension:

    python setup.py build_ext --inplace

Produces bwa_flow_tpu/_native*.so; the Python package falls back to the
golden NumPy implementations when the extension is absent.
"""

from setuptools import Extension, setup

setup(
    name="bwa_flow_tpu",
    version="0.1.0",
    packages=["bwa_flow_tpu", "bwa_flow_tpu_torch"],
    ext_modules=[
        Extension(
            "bwa_flow_tpu._native",
            sources=["native/_native.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-pthread"],
            extra_link_args=["-pthread"],
        ),
        Extension(
            "bwa_flow_tpu._chain",
            sources=["native/_chain.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
        Extension(
            "bwa_flow_tpu._region",
            sources=["native/_region.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
        Extension(
            "bwa_flow_tpu._markdup",
            sources=["native/_markdup.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
        Extension(
            "bwa_flow_tpu._wave",
            sources=["native/_wave.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
        Extension(
            "bwa_flow_tpu._bam",
            sources=["native/_bam.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-pthread"],
            extra_link_args=["-pthread"],
            libraries=["z"],
        ),
    ],
)
