"""Host IO (port of ``photon_ml_tpu/io``): the Avro container codec and
schemas, the Avro data reader, GLM and GAME model files, and scoring
results. Files interchange with the JAX package's in both directions."""

from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file  # noqa: F401
from photon_ml_tpu_torch.io.data_reader import AvroDataReader, GameDataset  # noqa: F401
from photon_ml_tpu_torch.io.model_io import (  # noqa: F401
    load_game_model,
    load_glm,
    model_fingerprint,
    save_game_model,
    save_glm,
)
from photon_ml_tpu_torch.io.schemas import (  # noqa: F401
    BAYESIAN_LINEAR_MODEL_SCHEMA,
    FEATURE_SUMMARIZATION_RESULT_SCHEMA,
    NAME_TERM_VALUE_SCHEMA,
    SCORING_RESULT_SCHEMA,
    TRAINING_EXAMPLE_SCHEMA,
)
