from . import camera, icp, knn, preprocess, pso, render, score  # noqa: F401
