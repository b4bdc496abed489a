"""The recipe sections that take a tokenizer, the trackers and GC control,
ported from the JAX package (`models/auto_tokenizer.py`,
`datasets/{chat,agent,column_mapped,presets}.py`,
`eval/tool_call_evaluator.py`, `loggers/trackers.py`,
`training/utils.GCController`, the `tokenizer`, `wandb`, `mlflow`, `comet`,
`gc_control` and `gc_every_steps` keys of `recipes/llm/train_ft.py`), held
to the JAX package on the CPU:

- the chat, agent, column-mapped and preset datasets give the same rows
  bit for bit under the stub tokenizers of tests/unit/test_trackers_chat.py
  (one token per character; a template with a one-time preamble; BPE
  merging across a message boundary) and under a BPE tokenizer the test
  trains with `tokenizers` and saves to `tmp_path` (no download), which
  `build_tokenizer` loads with the same ids and pad id in both packages;
- the tool-call parser and evaluator agree on every case;
- the JSONL mirrors of the three trackers equal JAX's except timestamps;
- the training recipe with a `tokenizer` section, a chat dataset, all three
  tracker sections and `gc_control` on: the loss curve within 1e-4 of a
  live JAX run from the same weights, each mirror's metric lines equal to
  `training.jsonl`'s values and shaped as JAX's, GC back on after the run,
  after a SIGTERM (the mirrors end "KILLED") and after a failure ("FAILED");
  a `resilience` section sets the SIGTERM grace, and an unknown key in it
  raises.
"""

import gc
import json
import os
import signal
import time

import jax
import numpy as np
import pytest

from automodel_tpu.config.loader import ConfigNode as JConfigNode
from automodel_tpu.datasets import agent as j_agent
from automodel_tpu.datasets import chat as j_chat
from automodel_tpu.datasets import column_mapped as j_column_mapped
from automodel_tpu.datasets import presets as j_presets
from automodel_tpu.eval import tool_call_evaluator as j_tce
from automodel_tpu.loggers import trackers as j_trackers
from automodel_tpu.models import auto_tokenizer as j_auto_tokenizer
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu.training.utils import GCController as JGCController
from automodel_tpu_torch.config import ConfigNode, load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.datasets import agent, chat, column_mapped, presets
from automodel_tpu_torch.eval import tool_call_evaluator as tce
from automodel_tpu_torch.loggers import trackers
from automodel_tpu_torch.models import auto_tokenizer
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.training import init_train_state
from automodel_tpu_torch.training.utils import GCController
from tests.unit.test_trackers_chat import (
    MergingTokenizer,
    StubTokenizer,
    TemplatedStubTokenizer,
)

TINY_YAML = "examples/llm_finetune/tiny_llama_mock_smoke.yaml"
STUBS = {"stub": StubTokenizer, "templated": TemplatedStubTokenizer,
         "merging": MergingTokenizer}

CHAT_ROWS = [
    {"messages": [{"role": "user", "content": "hi there"},
                  {"role": "assistant", "content": "hello a\nfriend"},
                  {"role": "user", "content": "bye"}]},
    {"messages": [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": "a"},
                  {"role": "assistant", "content": "ba"},
                  {"role": "user", "content": "and?"},
                  {"role": "assistant", "content": "done " * 30}]},
]
SHAREGPT_ROWS = [
    {"tools": [{"name": "get_weather", "parameters": {"city": "string"}}],
     "conversations": [
         {"from": "human", "value": "weather in Oslo and Rome?"},
         {"from": "function_call", "value": json.dumps(
             {"name": "get_weather", "arguments": {"city": "Oslo"}})},
         {"from": "function_call", "value": {"name": "get_weather",
                                             "arguments": {"city": "Rome"}}},
         {"from": "observation", "value": "cold; warm"},
         {"from": "gpt", "value": "Oslo is cold, Rome warm."}]},
    {"tools": "[]", "conversations": [
        {"role": "user", "content": "think first"},
        {"from": "gpt", "value": "let me call"},
        {"from": "tool_call", "value": "not json"},
        {"from": "tool_response", "value": 42}]},
    {"messages": [{"role": "user", "content": "plain"},
                  {"role": "assistant", "content": "chatml row"}]},
]


def _jsonl(path, rows):
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


def _assert_rows_equal(ds, jds):
    assert len(ds) == len(jds)
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} row {i}")


@pytest.mark.parametrize("assistant_only", [True, False])
@pytest.mark.parametrize("stub", sorted(STUBS))
def test_chat_dataset_rows_equal_jax(stub, assistant_only, tmp_path):
    path = _jsonl(tmp_path / "chat.jsonl", CHAT_ROWS)
    kw = dict(path=path, seq_len=96, train_on_assistant_only=assistant_only)
    ds = chat.ChatDatasetConfig(**kw).build(STUBS[stub]())
    _assert_rows_equal(ds, j_chat.ChatDatasetConfig(**kw).build(STUBS[stub]()))
    labels = ds[1]["labels"]
    assert (labels != -100).any() and (labels == -100).any() == assistant_only
    assert (ds[1]["input_ids"] != 0).all()  # the long reply is cut at seq_len


@pytest.mark.parametrize("stub", sorted(STUBS))
def test_agent_dataset_rows_equal_jax(stub, tmp_path):
    path = _jsonl(tmp_path / "agent.jsonl", SHAREGPT_ROWS)
    for row in SHAREGPT_ROWS:
        assert agent.normalize_agent_messages(row) == j_agent.normalize_agent_messages(row)
    msgs = agent.normalize_agent_messages(SHAREGPT_ROWS[0])
    assert msgs[0]["role"] == "system" and msgs[2]["content"].count("<tool_call>") == 2
    kw = dict(path=path, seq_len=400)
    _assert_rows_equal(agent.AgentChatDatasetConfig(**kw).build(STUBS[stub]()),
                       j_agent.AgentChatDatasetConfig(**kw).build(STUBS[stub]()))
    with pytest.raises(ValueError, match="sharegpt role"):
        agent.normalize_agent_messages({"conversations": [{"from": "bot", "value": ""}]})


SQUAD_FLAT = [{"context": "Paris is in France.", "question": "Where is Paris?",
               "answers": {"text": ["France"], "answer_start": [12]}},
              {"context": "c", "question": "q", "answers": [{"text": "list"}]},
              {"context": "c2", "question": "q2", "answer": "plain"}]
SQUAD_OFFICIAL = {"data": [{"title": "t", "paragraphs": [
    {"context": "Ice is cold.", "qas": [
        {"question": "What is cold?", "answers": [{"text": "Ice"}]},
        {"question": "Is it hot?", "answers": []}]}]}]}
HELLASWAG = [{"ctx": "A man opens a door", "endings": ["and sings.", "and walks in."],
              "label": "1"}, {"ctx": "x", "endings": [], "label": 0}]


def test_column_mapped_and_presets_rows_equal_jax(tmp_path):
    tok = StubTokenizer()
    cases = [
        (column_mapped.ColumnMappedTextInstructionDatasetConfig,
         j_column_mapped.ColumnMappedTextInstructionDatasetConfig,
         dict(path_or_dataset=_jsonl(tmp_path / "cm.jsonl", [
             {"ctx": "some context", "q": "why?", "a": "because"},
             {"ctx": "", "q": "empty", "a": "x" * 80}]),
             column_mapping={"context": "ctx", "question": "q", "answer": "a"},
             seq_len=48)),
        (column_mapped.ColumnMappedTextInstructionDatasetConfig,
         j_column_mapped.ColumnMappedTextInstructionDatasetConfig,
         dict(path_or_dataset=_jsonl(tmp_path / "cm2.jsonl", [
             {"context": "c", "question": "q", "answer": "ans"}]),
             answer_only_loss_mask=False, seq_len=32)),
        (presets.SquadDatasetConfig, j_presets.SquadDatasetConfig,
         dict(path_or_dataset=_jsonl(tmp_path / "squad.jsonl", SQUAD_FLAT), seq_len=80)),
        (presets.HellaSwagDatasetConfig, j_presets.HellaSwagDatasetConfig,
         dict(path_or_dataset=_jsonl(tmp_path / "hs.jsonl", HELLASWAG), seq_len=40)),
    ]
    official = tmp_path / "squad_official.json"
    official.write_text(json.dumps(SQUAD_OFFICIAL))
    cases.append((presets.SquadDatasetConfig, j_presets.SquadDatasetConfig,
                  dict(path_or_dataset=str(official), seq_len=64)))
    for cls, j_cls, kw in cases:
        ds = cls(**kw).build(tok)
        _assert_rows_equal(ds, j_cls(**kw).build(tok))
        assert (ds[0]["labels"] != -100).any()
    assert len(presets.SquadDatasetConfig(path_or_dataset=str(official)).build(tok)) == 2


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    """A byte-level BPE tokenizer trained here with `tokenizers`, a chat
    template and no pad token, saved as an HF tokenizer directory."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    corpus = [m["content"] for r in CHAT_ROWS for m in r["messages"]] * 5 + [
        "the weather in Oslo is cold", "tool calls and answers", "hello world"] * 5
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=200, special_tokens=["<unk>", "<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    from tokenizers import decoders

    tok.decoder = decoders.ByteLevel()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                                   eos_token="</s>", unk_token="<unk>")
    fast.chat_template = ("{% for m in messages %}<|{{ m['role'] }}|> {{ m['content'] }}\n"
                          "{% endfor %}{% if add_generation_prompt %}<|assistant|>{% endif %}")
    out = tmp_path_factory.mktemp("bpe")
    fast.save_pretrained(str(out))
    return str(out)


def test_build_tokenizer_gives_jax_ids(bpe_dir, tmp_path):
    tok = auto_tokenizer.build_tokenizer(bpe_dir)
    j_tok = j_auto_tokenizer.build_tokenizer(bpe_dir)
    assert tok.pad_token_id == tok.eos_token_id == j_tok.pad_token_id is not None
    for text in ("hello world", "the weather in Oslo is cold!", "zzz unseen ~"):
        ids = tok(text, add_special_tokens=False)["input_ids"]
        assert ids == j_tok(text, add_special_tokens=False)["input_ids"]
        assert tok.decode(ids) == text
    msgs = CHAT_ROWS[1]["messages"]
    for gen in (False, True):
        text = auto_tokenizer.apply_chat_template(tok, msgs, add_generation_prompt=gen)
        assert text == j_auto_tokenizer.apply_chat_template(j_tok, msgs,
                                                            add_generation_prompt=gen)
        assert text.startswith("<|system|> be brief\n")
    plain = StubTokenizer()
    assert auto_tokenizer.apply_chat_template(plain, msgs, True) == \
        j_auto_tokenizer.apply_chat_template(plain, msgs, True)
    path = _jsonl(tmp_path / "chat.jsonl", CHAT_ROWS)
    _assert_rows_equal(chat.ChatDatasetConfig(path=path, seq_len=128).build(tok),
                       j_chat.ChatDatasetConfig(path=path, seq_len=128).build(j_tok))


TOOL_TEXTS = [
    '<tool_call>{"name": "f", "arguments": {"x": 1}}</tool_call>',
    'text <tool_call> {"name": "f", "arguments": "{\\"x\\": \\"1 \\"}"} </tool_call> and '
    '<tool_call>{"function": {"name": "g"}, "parameters": {"y": [1, "A"]}}</tool_call>',
    '```json\n{"name": "h", "arguments": {}}\n```',
    '[{"name": "a", "arguments": {"k": "V"}}, {"arguments": {}}, 3]',
    '{"name": "solo", "arguments": "not json"}',
    "<tool_call>{broken}</tool_call>", "nothing here", "",
]


def test_tool_call_parser_and_evaluator_equal_jax():
    for text in TOOL_TEXTS:
        assert tce.parse_tool_calls(text) == j_tce.parse_tool_calls(text)
    refs = [tce.parse_tool_calls(t) for t in TOOL_TEXTS]
    preds = [TOOL_TEXTS[0], TOOL_TEXTS[1].replace('"A"', '" a "'), TOOL_TEXTS[3],
             TOOL_TEXTS[3], '{"name": "solo", "arguments": "other"}', "", "x",
             '<tool_call>{"name": "q"}</tool_call>']
    got = tce.evaluate_tool_calls(preds, refs)
    assert got == j_tce.evaluate_tool_calls(preds, refs)
    assert 0 < got["exact_accuracy"] < got["fuzzy_accuracy"] < got["name_accuracy"] < 1
    with pytest.raises(ValueError):
        tce.evaluate_tool_calls(["a"], [])


def _mirror_lines(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]


def test_tracker_mirrors_equal_jax_except_timestamps(tmp_path):
    cfg = {"lr": 1e-3, "nested": {"a": [1, 2]}, "name": "run"}
    for name, pkg in (("port", trackers), ("jax", j_trackers)):
        ts = pkg.build_trackers({"wandb": {"project": "p"}, "mlflow": {},
                                 "comet": {"workspace": "w"}}, str(tmp_path / name))
        assert [type(t).__name__ for t in ts] == ["WandbTracker", "MLflowTracker",
                                                   "CometTracker"]
        for t in ts:
            t.log_config(cfg)
            t.log({"loss": 1.5, "grad_norm": np.float32(0.25), "n": 3}, step=1)
            t.log({"loss": float("nan")}, step=2)
            t.finish("KILLED" if isinstance(t, pkg.MLflowTracker) else "FINISHED")
            t.log({"late": 1}, step=3)  # after finish: dropped
    for kind in ("wandb", "mlflow", "comet"):
        got = _mirror_lines(tmp_path / "port" / f"{kind}_metrics.jsonl")
        want = _mirror_lines(tmp_path / "jax" / f"{kind}_metrics.jsonl")
        assert json.dumps(got) == json.dumps(want)  # NaN included
        assert len(got) == 4 and got[0]["_config"] == cfg
    null = trackers.build_trackers(ConfigNode({"seed": 1}), str(tmp_path / "none"))
    assert null == [] and not os.path.exists(tmp_path / "none")


def test_gc_controller_matches_jax():
    assert gc.isenabled()
    for cls in (GCController, JGCController):
        c = cls(every_steps=2, enabled=True)
        assert not gc.isenabled() and gc.get_freeze_count() > 0
        c.step(1)
        c.step(2)
        c.close()
        assert gc.isenabled() and gc.get_freeze_count() == 0
        c.close()  # twice is fine
        off = cls(every_steps=2, enabled=False)
        assert gc.isenabled()
        off.close()


def _sft_node(node, tmp_path, name, bpe_dir, chat_path, **extra):
    node.set("run_dir", str(tmp_path / name))
    node.set("checkpoint.enabled", False)
    node.set("model.hf_config.vocab_size", 256)
    node.set("tokenizer", {"pretrained_path": bpe_dir})
    node.set("dataset", {"_target_": "automodel_tpu.datasets.chat.ChatDatasetConfig",
                         "path": chat_path, "seq_len": 64})
    node.set("dataloader.microbatch_size", 8)
    node.set("dataloader.grad_acc_steps", 1)
    node.set("step_scheduler.max_steps", 3)
    node.set("step_scheduler.num_epochs", 10)
    node.set("wandb", {"project": "p", "mode": "offline"})
    node.set("mlflow", {"experiment": "e"})
    node.set("comet", {"workspace": "w"})
    node.set("gc_control", True)
    node.set("gc_every_steps", 2)
    for k, v in extra.items():
        node.set(k, v)
    return node


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def sft_runs(bpe_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sft")
    chat_path = _jsonl(tmp / "chat.jsonl", CHAT_ROWS * 4)
    j_recipe = JRecipe(_sft_node(JConfigNode(load_yaml(TINY_YAML).to_dict()), tmp, "jax",
                                 bpe_dir, chat_path))
    j_recipe.setup()
    init = jax.tree.map(np.asarray, j_recipe.train_state.params)
    j_recipe.run_train_validation_loop()
    assert gc.isenabled()
    return tmp, init, chat_path


def _port(node, init, before_loop=None):
    recipe = TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu")
    recipe.setup()
    recipe.train_state = init_train_state(params_from_jax(init, device="cpu"), recipe.tx)
    if before_loop is not None:
        before_loop(recipe)
    recipe.run_train_validation_loop()
    return recipe


def test_sft_recipe_with_tokenizer_trackers_and_gc_matches_jax(sft_runs, bpe_dir):
    tmp, init, chat_path = sft_runs
    recipe = _port(_sft_node(load_yaml(TINY_YAML), tmp, "port", bpe_dir, chat_path), init)
    assert gc.isenabled()
    assert recipe._tokenizer.pad_token_id == recipe._tokenizer.eos_token_id
    assert isinstance(recipe.dataloader.dataset, chat.ChatDataset)
    recs, j_recs = _records(tmp / "port" / "training.jsonl"), _records(
        tmp / "jax" / "training.jsonl")
    losses = np.array([r["loss"] for r in recs])
    want = np.array([r["loss"] for r in j_recs])
    assert len(losses) == len(want) == 3
    assert (np.abs(losses - want) / np.abs(want)).max() <= 1e-4
    for r, j in zip(recs, j_recs):  # assistant-only labels: the same counts
        assert r["num_label_tokens"] == j["num_label_tokens"] < 8 * 64
    for kind in ("wandb", "mlflow", "comet"):
        got = _mirror_lines(tmp / "port" / f"{kind}_metrics.jsonl")
        j_got = _mirror_lines(tmp / "jax" / f"{kind}_metrics.jsonl")
        assert [sorted(x) for x in got] == [sorted(x) for x in j_got]
        assert got[-1] == j_got[-1] == {"step": None, "_status": "FINISHED"}
        cfg, j_cfg = got[0]["_config"], j_got[0]["_config"]
        assert cfg.pop("run_dir") != j_cfg.pop("run_dir")
        assert cfg == j_cfg
        for line, rec in zip(got[1:-1], recs):  # the records' values
            assert line == {k: v for k, v in rec.items() if k != "ts"}


def test_sft_recipe_gc_and_trackers_on_sigterm_and_failure(sft_runs, bpe_dir):
    tmp, init, chat_path = sft_runs

    def sigterm_at_step_2(recipe):
        run_step = recipe.run_step

        def step_then_signal(microbatches):
            out = run_step(microbatches)
            if recipe.step_scheduler.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(0.01)  # the handler runs between bytecodes
            return out

        recipe.run_step = step_then_signal

    previous = signal.getsignal(signal.SIGTERM)
    try:
        _port(_sft_node(load_yaml(TINY_YAML), tmp, "killed", bpe_dir, chat_path), init,
              before_loop=sigterm_at_step_2)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert gc.isenabled()
    for kind in ("wandb", "mlflow", "comet"):
        lines = _mirror_lines(tmp / "killed" / f"{kind}_metrics.jsonl")
        assert [x.get("step") for x in lines[1:-1]] == [1, 2]
        assert lines[-1] == {"step": None, "_status": "KILLED"}

    def fail_at_step_2(recipe):
        run_step = recipe.run_step

        def step_then_fail(microbatches):
            if recipe.step_scheduler.step == 2:
                assert not gc.isenabled()  # off during the run
                raise RuntimeError("boom")
            return run_step(microbatches)

        recipe.run_step = step_then_fail

    with pytest.raises(RuntimeError, match="boom"):
        _port(_sft_node(load_yaml(TINY_YAML), tmp, "failed", bpe_dir, chat_path), init,
              before_loop=fail_at_step_2)
    assert gc.isenabled()
    lines = _mirror_lines(tmp / "failed" / "wandb_metrics.jsonl")
    assert lines[-1] == {"step": None, "_status": "FAILED"}
    node = _sft_node(load_yaml(TINY_YAML), tmp, "res", bpe_dir, chat_path,
                     resilience={"sigterm_grace_s": 5})
    recipe = TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu")
    recipe.setup()  # the resilience section runs: its grace bounds the SIGTERM wait
    assert recipe.resilience_cfg.sigterm_grace_s == 5
    recipe.gc.close()  # setup turned GC off for the loop that does not run
    node = _sft_node(load_yaml(TINY_YAML), tmp, "res_bad", bpe_dir, chat_path,
                     resilience={"grace": 5})
    with pytest.raises(ValueError, match="grace"):
        TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu").setup()
    assert gc.isenabled()
