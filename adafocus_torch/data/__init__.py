"""Data layer of the port (counterpart of adafocus_tpu/data): video record
parsing (``records``), TSN segment sampling (``sampling``) and the host input
pipeline (``pipeline``, ``native``): numpy copies of the JAX package's
modules, so that batches are identical for the same seed; the on-device
augmentation in PyTorch (``transforms``); the dataset cache in host RAM or
on the card (``cache``); prefetching (``prefetch``); and the generated
mini-ActivityNet set (``miniact``) and the video-to-JPEG extractor
(``video_jpg``).
"""
