"""Object fitting and scene assembly (counterpart of ``lsdm_tpu/fitting``).

The pose search (36 x 11 x 11 poses in batched tensor ops) and the Adam
refinement run on a torch device (``place_obj.py``); host-side geometry
(DBSCAN clustering, voxel downsampling, the SDF) uses the native C++
libraries in ``native/``, loaded by path (``native.py``, ``sdf.py``).
``fitting/next_obj_class.py`` samples an ATISS model and is not ported
here.
"""
