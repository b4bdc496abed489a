"""CLI entry: ``python -m automodel_tpu_torch <cfg.yaml> [--key.path=value ...]``
(port of `automodel_tpu/cli/app.py`), on one card, or on N under
``torchrun --nproc-per-node N -m automodel_tpu_torch <cfg.yaml>``: each rank
joins the process group the launcher describes (NCCL) and the recipe lays
its state out on the YAML's `distributed` mesh; the group is torn down when
the run ends.

The recipe class resolves from the ``recipe._target_`` field (JAX-package
names map to the port's), a bare ``recipe:`` alias, or the default
next-token-prediction trainer. The training aliases and `llm_serve` are
ported, with `llm_seq_cls` and the bi- and cross-encoder retrieval
recipes; the others raise and name the recipe.
"""

from __future__ import annotations

from automodel_tpu_torch.config import ConfigNode, parse_args_and_load_config
from automodel_tpu_torch.config.loader import _resolve_target

_TRAIN_FT = "automodel_tpu_torch.recipes.llm.train_ft.TrainFinetuneRecipeForNextTokenPrediction"
_SERVE = "automodel_tpu_torch.recipes.llm.serve.ServeRecipe"

RECIPE_ALIASES = {
    "llm_train_ft": _TRAIN_FT,
    "llm_finetune": _TRAIN_FT,
    "llm_pretrain": _TRAIN_FT,
    "llm_serve": _SERVE,
    "llm_seq_cls": "automodel_tpu_torch.recipes.llm.train_seq_cls.TrainSeqClsRecipe",
    "retrieval_bi_encoder":
        "automodel_tpu_torch.recipes.retrieval.train_bi_encoder.TrainBiEncoderRecipe",
    "retrieval_cross_encoder":
        "automodel_tpu_torch.recipes.retrieval.train_cross_encoder.TrainCrossEncoderRecipe",
}

# the JAX CLI's other aliases: recipes this package does not have yet
UNPORTED_RECIPES = (
    "llm_benchmark", "llm_kd", "llm_train_eagle3", "llm_train_eagle1",
    "llm_train_eagle2", "llm_train_dflash", "llm_spec_bench",
    "llm_dflash_decode_eval", "dllm_train_ft", "diffusion_train",
    "bagel_finetune", "multimodal_pretrain", "vlm_finetune", "vlm_kd",
    "vlm_generate", "multimodal_finetune",
    "retrieval_distill_bi_encoder", "retrieval_mine_hard_negatives",
)


def resolve_recipe_class(cfg: ConfigNode):
    node = cfg.get("recipe")
    if node is None:
        path = RECIPE_ALIASES["llm_train_ft"]
    elif isinstance(node, str):
        if node in UNPORTED_RECIPES:
            raise NotImplementedError(f"recipe '{node}' is not ported yet")
        path = RECIPE_ALIASES.get(node, node)
    elif "_target_" in node:
        path = node.get("_target_")
    else:
        path = RECIPE_ALIASES["llm_train_ft"]
    return _resolve_target(path)


def main(argv=None, device=None):
    """Load the YAML and overrides, build the recipe on `device` (None, as
    from the command line, means CUDA; the CPU only when asked for), run it
    (train or serve); returns the recipe (its state and logs stay readable
    by the caller)."""
    from automodel_tpu_torch.distributed import destroy_distributed, launched_distributed

    cfg = parse_args_and_load_config(argv)
    recipe = resolve_recipe_class(cfg)(cfg, device=device)
    try:
        recipe.setup()
        recipe.run_train_validation_loop()
    finally:
        if launched_distributed():
            destroy_distributed()
    return recipe
