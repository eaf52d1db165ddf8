from photon_ml_tpu_torch.supervised.training import GLMTrainingResult, train_glm  # noqa: F401
