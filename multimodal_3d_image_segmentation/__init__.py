"""JAX framework for multimodal 2D/3D medical image segmentation.

A from-scratch JAX/XLA re-design with the capabilities of
IBM/multimodal-3d-image-segmentation: frequency-domain neural operators
(HNOSeg-XS, HartleyMHA, FNOSeg3D/HNOSeg) and a V-Net-DS CNN baseline, plus
the experiment runtime (config-driven training/testing/statistics) and
native data IO.
"""

__version__ = "0.1.0"
