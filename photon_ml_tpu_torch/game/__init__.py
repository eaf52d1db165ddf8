"""GAME (generalized additive mixed effects) training, in memory: one
columnar ``GameBatch`` on the device, entities grouped and bucketed once on
the host, each random effect solved as lanes of one batched damped-Newton
loop per bucket, and coordinate descent over the coordinates' residuals.
The fixed effect's objective passes run on K1 (``ops/fused.py``)."""

from photon_ml_tpu_torch.game.data import (  # noqa: F401
    DenseFeatures,
    EntityBuckets,
    EntityGrouping,
    GameBatch,
    SparseFeatures,
    bucket_entities,
    capacity_classes,
    group_by_entity,
    make_game_batch,
)
from photon_ml_tpu_torch.game.random_effect import (  # noqa: F401
    RandomEffectTrainingResult,
    random_effect_scores,
    train_random_effects,
)
from photon_ml_tpu_torch.game.models import (  # noqa: F401
    FixedEffectModel,
    GameModel,
    GameSubModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.coordinate import (  # noqa: F401
    Coordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.descent import CoordinateDescent, CoordinateDescentResult  # noqa: F401
