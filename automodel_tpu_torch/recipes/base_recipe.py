"""Recipe base class (port of `automodel_tpu/recipes/base_recipe.py`): the
raw config, its typed facade and the train state.

The JAX base class also registers every attribute with a state_dict for the
checkpoint and saves and restores through the checkpointer. The
checkpointer is not ported (ROADMAP.md queue 1), so recipes refuse
`checkpoint.enabled: true` and nothing here saves or restores yet.
"""

from __future__ import annotations

from automodel_tpu_torch.config import ConfigNode
from automodel_tpu_torch.recipes.typed_config import RecipeConfig


class BaseRecipe:
    def __init__(self, cfg: ConfigNode):
        self.cfg = cfg
        self.typed = RecipeConfig(cfg)
        self.train_state = None
