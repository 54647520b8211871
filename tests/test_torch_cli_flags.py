"""The port's CLIs (inference, eval, train, serving) take the JAX CLIs'
flags, and refuse --fast_infer as the JAX CLI does.

The oracle is the JAX package itself: each JAX CLI module is imported in a
subprocess of its own (both define their flags into absl's one global
registry at import, so they cannot share a process) and its flags' names,
types and defaults are read back.
"""

import functools
import json
import os
import subprocess
import sys

import pytest

from learnablepoolingmethods_torch import cli_flags, inference, serving, train
from learnablepoolingmethods_torch import eval as eval_cli
from learnablepoolingmethods_torch.models import list_models as torch_models
from learnablepoolingmethods_torch.ops.fast_dispatch import get_fast_path

from learnablepoolingmethods_tpu.models import list_models as jax_models
from learnablepoolingmethods_tpu.ops.fast_dispatch import get_fast_path as jax_get_fast_path

CLIS = {"inference": inference, "eval": eval_cli, "train": train}

_DUMP = """
import json, sys
import learnablepoolingmethods_tpu.{cli}
from absl import flags
by_module = flags.FLAGS.flags_by_module_dict()
out = {{}}
for module in ("learnablepoolingmethods_tpu.flags", "learnablepoolingmethods_tpu.{cli}"):
    for flag in by_module.get(module, []):
        out[flag.name] = [flag.flag_type(), flag.default]
json.dump(out, sys.stdout)
"""


@functools.lru_cache(maxsize=None)
def jax_flags(cli: str) -> dict:
    """{name: (absl type, default)} of every flag the JAX ``cli`` defines
    from flags.py and from its own module."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _DUMP.format(cli=cli)], capture_output=True,
                         text=True, env=env, timeout=300, check=True).stdout
    return {name: tuple(v) for name, v in json.loads(out).items()}


def _argv(flags: dict) -> list:
    """The command line that sets every flag of ``flags`` to its value."""
    return [f"--{n}={str(v).lower() if isinstance(v, bool) else v}" for n, v in flags.items()]


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_parser_defines_every_jax_flag_with_its_default(cli):
    want = jax_flags(cli)
    defaults = vars(CLIS[cli].build_parser().parse_args([]))
    missing = sorted(set(want) - set(defaults))
    assert not missing, f"the port's {cli} CLI lacks {missing}"
    for name, (kind, default) in want.items():
        assert defaults[name] == default and type(defaults[name]) is type(default), name
    # and every name of flags.py, int8_hidden included, on both CLIs
    assert set(cli_flags.FLAGS_PY) <= set(defaults)


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_jax_command_line_at_its_defaults_parses_to_the_same_values(cli):
    """Every JAX flag spelled out at the JAX default parses through the
    port's parser to that value, and builds the CLI's configuration without
    raising."""
    want = {n: d for n, (_, d) in jax_flags(cli).items()}
    args = CLIS[cli].build_parser().parse_args(_argv(want))
    for name, default in want.items():
        assert getattr(args, name) == default, name
    if cli in ("inference", "eval"):
        mcfg = cli_flags.model_config_from_args(args)
    else:
        _, mcfg, _ = train.configs_from_args(args)
    assert mcfg.vocab_size == want["num_classes"] and mcfg.compute_dtype == want["compute_dtype"]


def _off_default(default):
    if isinstance(default, bool):
        return not default
    if isinstance(default, str):
        return default + "x" if default else "/some/path"
    return default + 2


# the mesh's flags (ROADMAP item 15), which the CLIs refused with
# NotImplementedError until the mesh was ported (one case for each (CLI,
# flag)): on one process a mesh of two does not fit, and each CLI raises
# create_mesh's ValueError, as the JAX CLI does on one device
# (tests/test_torch_mesh.py holds the text to JAX's)
ITEM_15 = [(cli, name) for cli in ("inference", "eval", "train") for name in ("model_parallelism", "dcn_parallelism")]


@pytest.mark.parametrize("cli, name", ITEM_15)
def test_item_15_mesh_flags_raise_create_meshs_value_error_on_one_process(tmp_path, cli, name):
    argv = _argv({name: 2})
    want = "mesh 1x0x2 != 1 devices" if name == "model_parallelism" else "mesh 2x0x1 != 1 devices"
    with pytest.raises(ValueError, match=want):
        if cli == "inference":
            inference.main(argv + ["--fast_infer", "--model=NetVLADModelLF", "--frame_features",
                                   f"--input_data_pattern={tmp_path}/none*",
                                   f"--output_file={tmp_path}/o.csv", "--device=cpu"])
        elif cli == "eval":
            eval_cli.main(argv + ["--model=NetVLADModelLF", "--frame_features", "--run_once",
                                  f"--eval_data_pattern={tmp_path}/none*", f"--train_dir={tmp_path}/m",
                                  "--device=cpu"])
        else:
            train.main(argv + ["--model=NetVLADModelLF", "--frame_features",
                               f"--train_data_pattern={tmp_path}/none*",
                               f"--train_dir={tmp_path}/m", "--device=cpu"])


# item 12b's flags, which the CLIs refused before they were ported (one
# case for each (CLI, flag) they refused): what each does now, as
# the JAX CLI
ITEM_12B = [("inference", "bf16_params"), ("inference", "fused_adam"), ("eval", "bf16_params"),
            ("eval", "fused_adam"), ("eval", "int8_hidden"), ("train", "int8_hidden"), ("train", "use_remat"),
            ("train", "bf16_params"), ("train", "fused_adam"), ("train", "grad_accum_steps")]


@pytest.mark.parametrize("cli, name", ITEM_12B)
def test_item_12b_flags_are_taken_as_the_jax_cli_takes_them(tmp_path, cli, name):
    defaults = vars(CLIS[cli].build_parser().parse_args([]))
    args = CLIS[cli].build_parser().parse_args(
        _argv({name: _off_default(defaults[name])}) + ["--model=NetVLADModelLF", "--frame_features"])
    if name == "int8_hidden" and cli == "train":
        # the JAX trainer defines no --int8_hidden
        with pytest.raises(ValueError, match="the JAX trainer defines no such flag"):
            train.configs_from_args(args)
    elif name == "int8_hidden":
        # the JAX eval CLI's check: --int8_hidden needs --fast_forward
        with pytest.raises(ValueError, match="--int8_hidden requires --fast_forward"):
            eval_cli.main(_argv({name: True}) + ["--model=NetVLADModelLF", "--frame_features", "--run_once",
                                                  f"--eval_data_pattern={tmp_path}/none*",
                                                  f"--train_dir={tmp_path}/m", "--device=cpu"])
    elif cli == "train":
        _, mcfg, tcfg = train.configs_from_args(args)
        # flags.py#training_config_from_flags and #model_config_from_flags
        assert tcfg.use_remat == args.use_remat and tcfg.grad_accum_steps == args.grad_accum_steps
        assert tcfg.fp32_master == (args.bf16_params and not args.fused_adam)
        assert tcfg.fused_adam == args.fused_adam
        assert mcfg.param_dtype == ("bfloat16" if name in ("bf16_params", "fused_adam") else "float32")
    else:
        assert cli_flags.model_config_from_args(args).param_dtype == "bfloat16"


# item 11's flags, the RNNs' widths, which the CLIs refused before the
# RNNs were ported (one case for each (CLI, flag) they refused):
# each builds the model's configuration at its value, as the JAX CLI does
ITEM_11 = [(cli, name) for cli in ("inference", "eval", "train")
           for name in ("lstm_cells", "lstm_layers", "gru_cells", "gru_layers")]


@pytest.mark.parametrize("cli, name", ITEM_11)
def test_item_11_flags_are_taken_as_the_jax_cli_takes_them(cli, name):
    defaults = vars(CLIS[cli].build_parser().parse_args([]))
    value = _off_default(defaults[name])
    model = "LstmModel" if name.startswith("lstm") else "GruModel"
    args = CLIS[cli].build_parser().parse_args(_argv({name: value}) + [f"--model={model}", "--frame_features"])
    if cli == "train":
        _, mcfg, _ = train.configs_from_args(args)
    else:
        mcfg = cli_flags.model_config_from_args(args)
    # flags.py#model_config_from_flags: the field of the flag's name
    assert getattr(mcfg, name) == value


# item 7's flags, the input sources and --profile_dir, which the CLIs
# refused before ingest was ported (one case for each (CLI, flag) they
# refused): each now selects what the JAX CLI selects
ITEM_7 = ([(cli, name) for cli in ("inference", "eval", "train")
           for name in ("num_readers", "use_grain", "grain_worker_count", "packed_cache_dir")]
          + [("train", "use_native_reader"), ("train", "profile_dir")])


@pytest.mark.parametrize("cli, name", ITEM_7)
def test_item_7_flags_are_taken_as_the_jax_cli_takes_them(tmp_path, cli, name):
    """A source flag reaches its source, which finds no files
    (flags.py#input_iterator; train.py's --use_native_reader); a flag that
    only tunes a source (--num_readers, --grain_worker_count) keeps the
    streaming reader, as in the JAX CLIs; --profile_dir traces into its
    directory (tests/test_torch_ingest_cli.py runs each source)."""
    defaults = vars(CLIS[cli].build_parser().parse_args([]))
    value = str(tmp_path / "cache") if name == "packed_cache_dir" else _off_default(defaults[name])
    argv = _argv({name: value}) + ["--model=NetVLADModelLF", "--frame_features", "--feature_names=rgb,audio",
                                   f"--train_data_pattern={tmp_path}/none*", f"--train_dir={tmp_path}/m"]
    args = CLIS[cli].build_parser().parse_args([a for a in argv if cli == "train" or "train_data" not in a])
    if name == "profile_dir":
        from learnablepoolingmethods_torch.core.observability import profile_session

        with profile_session(args.profile_dir) as trace:
            assert os.path.dirname(trace) == args.profile_dir and trace.endswith(".pt.trace.json")
        assert os.path.exists(trace)
        return
    fcfg, mcfg, tcfg = train.configs_from_args(train.build_parser().parse_args(argv))
    with pytest.raises(IOError, match="Unable to find input files"):
        if cli == "train":
            next(train.Trainer(args)._batches(fcfg, mcfg, tcfg))
        else:
            next(cli_flags.input_iterator(args, fcfg, f"{tmp_path}/none*", 8, 1))


def test_item_14_flag_is_taken_as_the_jax_cli_takes_it():
    """--export_model_steps, which the trainer refused before export was
    ported: the cadence of flags.py#training_config_from_flags."""
    args = train.build_parser().parse_args(["--export_model_steps=7", "--model=NetVLADModelLF",
                                            "--frame_features"])
    assert train.configs_from_args(args)[2].export_model_steps == 7


def test_serving_cli_takes_every_jax_serving_flag_under_its_default():
    """The serving CLI (argparse) defines every flag of the JAX serving
    module's define_flags, int8_hidden included, with its default and
    type, and --device; the JAX spelling of each parses to its value."""
    want = jax_flags("serving")
    defaults = vars(serving.build_parser().parse_args([]))
    assert set(defaults) == set(want) | {"device"} and defaults["device"] == "cuda"
    for name, (kind, default) in want.items():
        assert defaults[name] == default and type(defaults[name]) is type(default), name
    args = serving.build_parser().parse_args(_argv({n: d for n, (_, d) in want.items()}))
    assert vars(args) == defaults
    off = serving.build_parser().parse_args(["--fast_serve", "--noint8_hidden", "--batch_linger_ms=0.5"])
    assert off.fast_serve and not off.int8_hidden and off.batch_linger_ms == 0.5


def test_flags_without_an_effect_here_are_accepted():
    """--num_gpu (ignored by the JAX CLIs too) and, at inference, the
    training schedule's flags parse and raise nothing, as in the JAX CLI."""
    args = inference.build_parser().parse_args(
        ["--num_gpu=4", "--base_learning_rate=0.5", "--max_steps=7", "--seed=3", "--use_remat"])
    assert args.num_gpu == 4 and args.max_steps == 7
    cli_flags.model_config_from_args(args)
    train.configs_from_args(train.build_parser().parse_args(
        ["--num_gpu=4", "--model=NetVLADModelLF", "--frame_features"]))


@pytest.mark.parametrize("model_name", sorted(set(jax_models()) | set(torch_models())))
def test_fast_infer_refuses_exactly_the_models_without_a_jax_fast_path(model_name):
    """Where the JAX registry has no fast path, --fast_infer raises
    ValueError in both CLIs (learnablepoolingmethods_tpu/inference.py);
    where it has one, the port serves it (DbofModel's included, the last
    one ported)."""
    if jax_get_fast_path(model_name) is None:
        with pytest.raises(ValueError, match="--fast_infer supports"):
            get_fast_path(model_name)
    else:
        path = get_fast_path(model_name)
        assert callable(path.prepare) and callable(path.build)
