"""Avro schemas for data and model interchange (own copy of
``photon_ml_tpu/io/schemas.py``): the ``photon-avro-schemas`` record shapes
``TrainingExampleAvro``, ``NameTermValueAvro``, ``BayesianLinearModelAvro``,
``ScoringResultAvro`` and ``FeatureSummarizationResultAvro``, field for
field as the JAX package writes them, so either package reads the other's
files.
"""

from __future__ import annotations

NAMESPACE = "com.linkedin.photon.avro.generated"

NAME_TERM_VALUE_SCHEMA = {
    "type": "record",
    "name": "NameTermValueAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_SCHEMA = {
    "type": "record",
    "name": "TrainingExampleAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "uid", "type": ["null", "string", "long"], "default": None},
        {"name": "response", "type": "double"},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "features", "type": {"type": "array", "items": NAME_TERM_VALUE_SCHEMA}},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

BAYESIAN_LINEAR_MODEL_SCHEMA = {
    "type": "record",
    "name": "BayesianLinearModelAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
        {
            "name": "means",
            "type": {"type": "array", "items": "NameTermValueAvro"},
        },
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
    ],
}
# NameTermValueAvro must be defined before first reference when both appear
# in one file's schema; model files embed the full definition:
BAYESIAN_LINEAR_MODEL_SCHEMA["fields"][3]["type"]["items"] = NAME_TERM_VALUE_SCHEMA

SCORING_RESULT_SCHEMA = {
    "type": "record",
    "name": "ScoringResultAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "uid", "type": ["null", "string", "long"], "default": None},
        {"name": "predictionScore", "type": "double"},
        {"name": "label", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

FEATURE_SUMMARIZATION_RESULT_SCHEMA = {
    "type": "record",
    "name": "FeatureSummarizationResultAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}
