"""Fitting hyper-parameters (reference ``config.py:1-46``).

A copy of ``lsdm_tpu/fitting/config.py`` (the port imports nothing of the
JAX package).  Class ids are mpcat40 ids
(``fitting/meshio.py:MPCAT40_CLASS_IDS``).
"""

# Per-class DBSCAN eps for contact-point clustering (reference classes_eps).
CLASSES_EPS = {
    3: 0.2,  # chair
    5: 0.2,  # table
    7: 0.2,  # cabinet
    10: 0.8,  # sofa
    11: 1.0,  # bed
    19: 0.1,  # stool
    31: 0.2,  # shelf
}

VOTING_EPS = 0.1
VOXEL_SIZE = 0.04
CLUSTER_MIN_POINTS = 9
PTS_PER_UNIT = 20

FITTING_PARAMS = {
    "default": {
        "grid_search_contact_weight": 100.0,
        "grid_search_pen_thresh": -0.05,
        "grid_search_classes_pen_weight": {
            3: 10.0, 5: 10.0, 7: 10.0, 10: 10.0, 11: 10.0, 19: 10.0, 31: 1.0,
        },
        "lr": 0.003,
        "opt_steps": 200,
        "opt_contact_weight": 100.0,
        "opt_pen_thresh": 0.0,
        "opt_classes_pen_weight": {
            3: 1.0, 5: 100.0, 7: 1.0, 10: 10.0, 11: 10.0, 19: 1.0, 31: 1.0,
        },
    }
}
