"""The port's public API against the JAX package's, name for name.

Both packages are read with `ast` (neither is imported). For every module
of `videosys_tpu/`, each public top-level function and class, each public
method of those classes and each field of the dataclasses must have a
counterpart at the same module path in `videosys_tpu_torch/`: a top-level
name the port module defines (or imports), a member its class defines
(also as `self.name = ...`) or inherits from a base class of the same port
module. The package's own `__all__` must be the port's too. What the port
deliberately has no counterpart of stands in `NO_COUNTERPART`, one reason a
row; a row names a module, a name or a member (a module or class row covers
all it holds)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "videosys_tpu", ROOT / "videosys_tpu_torch"

FLAX_SETUP = "Flax `setup`; a port module builds its submodules in `__init__`"
FLAX_INIT = ("Flax param init; the port's modules draw their weights when "
             "built (`core.pipeline.build_modules`, from a seed)")
FLAX_DTYPE = ("the Flax compute dtype; a port module computes in its "
              "parameters' dtype, set by `.to(dtype)`")
SCAN = ("a `jax.lax.scan` wrapper over stacked blocks; the port loops over "
        "its blocks in Python")
MESH = ("a JAX mesh helper; the port passes process groups "
        "(`core.parallel.Groups`) and shards explicitly")
GSPMD = ("a GSPMD sharding constraint; the port splits and gathers tensors "
         "itself (`core.parallel.split`, `all_to_all`, `gather`)")

NO_COUNTERPART = {
    # JAX / XLA-only modules (ROADMAP Queue 1, "Nothing to port")
    "native": "a g++ latent-file reader for the JAX data loader; the port "
              "reads latents on a thread pool (`training.datasets`)",
    "utils.convert": "torch state_dict -> Flax params; the port keeps the "
                     "reference's key names and loads them as they are",
    "utils.hlo": "collective bytes read from XLA's compiled program; the "
                 "port counts its own (`core.parallel.EXCHANGE`)",
    "utils.jit": "jit / persistent-compile helpers; the port runs eagerly",
    "utils.params": "casts a Flax param pytree; the port casts modules "
                    "with `.to(dtype)`",
    # the mesh (the port's counterparts are process groups)
    "build_mesh": "top-level export of `core.parallel.build_mesh`; the "
                  "port's is `core.parallel.build_groups`",
    "core.parallel.build_mesh": "the port's is `core.parallel.build_groups`",
    "core.parallel.single_device_mesh": "world 1 is no groups at all "
                                        "(`groups=None`)",
    "core.parallel.use_mesh": "the port's is `core.parallel.use_groups`",
    "core.parallel.active_mesh": "the port's is "
                                 "`core.parallel.active_groups`",
    "core.parallel.mesh_world_size": "the port's is `Groups.world_size`",
    "core.parallel.mesh_axis_size": "the port's is `core.parallel.axis_size`",
    "core.parallel.MeshPool": "the port's is `core.parallel.GroupsPool`",
    "core.parallel.io_sharding": MESH,
    "core.parallel.replicated": MESH,
    "core.parallel.shard_merged_rows": GSPMD,
    "core.parallel.shard_cross_rows": GSPMD,
    # sharded training state (the port's ZeRO lives in the optimizer)
    "training.ema.shard_ema": "the EMA under a dp sharding; under ZeRO-3 "
                              "the port keeps per-rank EMA fragments "
                              "(`training.zero3`)",
    "training.ema.gather_ema": "gathers a sharded EMA for a checkpoint; "
                               "the port's is `Zero3.unshard`",
    "training.train_step.zero1_shardings": "ZeRO-1 as shardings; the port's "
                                           "is `ClippedAdamW`'s flat "
                                           "reduce-scattered moments",
    "training.train_step.zero3_shardings": "ZeRO-3 as shardings; the port's "
                                           "is `training.zero3.Zero3`",
    "training.train_step.zero1_leaf_sharding": "chooses a leaf's "
                                               "NamedSharding; the port "
                                               "shards flat buffers",
    "training.train_step.zero1_sharded_fraction": "reads the ZeRO-1 "
                                                  "shardings; the port's "
                                                  "moments are all sharded "
                                                  "(`ClippedAdamW."
                                                  "moment_bytes`)",
    "training.train_step.TrainState.params": "a pytree field; the port's "
                                             "TrainState holds the module "
                                             "(`model`)",
    "training.train_step.TrainState.opt_state": "a pytree field; the "
                                                "port's TrainState holds "
                                                "the optimizer (`tx`)",
    "training.train_step.TrainState.tree_flatten": "pytree registration",
    # Flax-only constructs
    "models.modules.embeddings.CaptionEmbedder.setup": FLAX_SETUP,
    "models.autoencoders.vae2d.AutoencoderKL2D.setup": FLAX_SETUP,
    "models.autoencoders.vae_temporal.VAETemporal.setup": FLAX_SETUP,
    "models.autoencoders.autoencoder_causal_vae.CausalVAE.init": FLAX_INIT,
    "models.autoencoders.autoencoder_cogvideox.AutoencoderKLCogVideoX.init":
        FLAX_INIT,
    "models.autoencoders.autoencoder_open_sora.OpenSoraVAE.init": FLAX_INIT,
    "models.autoencoders.autoencoder_causal_vae.CausalVAEModule":
        "the Flax module behind CausalVAE (for init); the port's CausalVAE "
        "is the module",
    "models.autoencoders.autoencoder_causal_vae.CausalVAEConfig.dtype":
        FLAX_DTYPE,
    "models.autoencoders.autoencoder_cogvideox.CogVideoXVAEConfig.dtype":
        FLAX_DTYPE,
    "models.autoencoders.autoencoder_open_sora.OpenSoraVAEConfig.dtype":
        FLAX_DTYPE,
    "models.transformers.cogvideox.CogVideoXConfig.dtype": FLAX_DTYPE,
    "models.modules.normalization.GroupNormMXU": "GroupNorm without the "
                                                 "group reshape, for the "
                                                 "TPU's MXU; the port's is "
                                                 "`normalization.GroupNorm`",
    "models.transformers.cogvideox.CogVideoXScannedBlock": SCAN,
    "models.transformers.open_sora_plan_v120.V120ScannedBlock": SCAN,
    "models.transformers.vchitect.VchitectScannedBlock": SCAN,
    "models.transformers.latte.LatteDepthPair": SCAN,
    "models.transformers.stdit3.STDiT3DepthPair": SCAN,
    # the same computation under another name or in another module
    "models.modules.embeddings.apply_rope": "the port's is "
                                            "`rope_channel_tables` + "
                                            "`apply_rope_channel` (the same "
                                            "rotation, channel layout)",
    "models.transformers.cogvideox.apply_rope_interleaved":
        "the port calls `embeddings.rotate_interleaved_pairs` with the fp32 "
        "tables itself",
    "models.transformers.latte.GEGLUFeedForward": "the port's is "
                                                  "`modules.blocks."
                                                  "FeedForward`",
    "models.transformers.latte.LatteSpatialBlock": "the port's is "
                                                   "`LatteBlock(temporal="
                                                   "False)`",
    "models.transformers.latte.LatteTemporalBlock": "the port's is "
                                                    "`LatteBlock(temporal="
                                                    "True)`",
    "models.transformers.open_sora_plan_v120.V120SelfAttention":
        "the port's is `modules.blocks.Attention` (V120Block.attn1), RoPE "
        "applied by the block",
    "models.transformers.open_sora_plan_v120.V120CrossAttention":
        "the port's is `modules.blocks.Attention` (V120Block.attn2)",
    # never read in the JAX package
    "schedulers.pndm.PNDMConfig.timestep_spacing": "never read: JAX's "
                                                   "`set_timesteps` always "
                                                   "spaces the ladder "
                                                   "\"leading\", as the "
                                                   "port's does",
    "models.transformers.cogvideox.CogVideoXConfig.sample_frames":
        "never read: the request gives the frames",
    "models.transformers.cogvideox.CogVideoXConfig.sample_height":
        "never read: the request gives the height",
    "models.transformers.cogvideox.CogVideoXConfig.sample_width":
        "never read: the request gives the width",
    "core.pab.PABStepPlan.key": "never read: an identity property (a plan, "
                                "frozen, is its own key)",
}

# the names this table must never hold: the last ones the port gained
PORTED_LAST = (
    "models.autoencoders.autoencoder_cogvideox.AutoencoderKLCogVideoX.encode",
    "schedulers.ddim.DDIMScheduler.add_noise",
    "schedulers.pndm.PNDMScheduler.add_noise",
    "schedulers.euler_ancestral.EulerAncestralScheduler.add_noise",
    "core.pipeline.VideoSysPipeline.save_video",
    "pipelines.latte.pipeline_latte.LattePipeline.save_video",
    "pipelines.open_sora_plan.pipeline_open_sora_plan.OpenSoraPlanPipeline"
    ".save_video",
    "pipelines.latte.pipeline_latte.LatteConfig.vae",
    "pipelines.open_sora_plan.pipeline_open_sora_plan.OpenSoraPlanConfig.vae",
    "pipelines.vchitect.pipeline_vchitect.VchitectConfig.vae",
    "utils.timing.profile_trace",
    "ParallelConfig",
    "utils.checkpoint.load_stdit3_torch_checkpoint",
)


def module_paths(pkg: Path) -> dict:
    """{dotted module path inside the package ("" for its __init__): file}."""
    out = {}
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(pkg).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = path
    return out


class Module:
    """A module's top-level names, its classes and its `__all__`."""

    def __init__(self, path: Path):
        tree = ast.parse(path.read_text(), str(path))
        self.names, self.classes, self.exports = set(), {}, []
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                self.names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    self.classes[node.name] = node
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                self.names.update((a.asname or a.name).split(".")[0]
                                  for a in node.names)
            for target in _targets(node):
                self.names.add(target)
                if target == "__all__":
                    self.exports = list(ast.literal_eval(node.value))
        self.defined = {n.name for n in tree.body if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}

    def members(self, cls: str, seen=()) -> set:
        """What the port's class has: its methods, class attributes and
        `self.x` attributes, and those of its bases in this module."""
        node = self.classes[cls]
        out = {t for n in node.body for t in _targets(n)}
        out.update(n.name for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
        out.update(n.attr for n in ast.walk(node)
                   if isinstance(n, ast.Attribute)
                   and isinstance(n.ctx, ast.Store)
                   and isinstance(n.value, ast.Name) and n.value.id == "self")
        for base in node.bases:
            if isinstance(base, ast.Name) and base.id in self.classes \
                    and base.id not in seen:
                out |= self.members(base.id, seen + (cls,))
        return out

    def public_api(self, cls: str) -> list:
        """A JAX class's public methods, and its fields if a dataclass."""
        node = self.classes[cls]
        dataclass = any("dataclass" in ast.unparse(d)
                        for d in node.decorator_list)
        out = [n.name for n in node.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        if dataclass:
            out += [n.target.id for n in node.body
                    if isinstance(n, ast.AnnAssign)
                    and isinstance(n.target, ast.Name)]
        return [m for m in out if not m.startswith("_")]


def _targets(node) -> list:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


JAX_MODULES = {name: Module(p) for name, p in module_paths(JAX_PKG).items()}
PORT_MODULES = {name: Module(p) for name, p in module_paths(PORT_PKG).items()}


def qual(module: str, *names: str) -> str:
    return ".".join((module,) + names) if module else ".".join(names)


def jax_api(module: str) -> list:
    """The public names of one JAX module, qualified: the package's
    `__all__`, each public top-level function and class, and each public
    member of those classes."""
    mod = JAX_MODULES[module]
    out = [qual(module, n) for n in mod.exports] if module == "" else []
    for name in sorted(mod.defined):
        if name.startswith("_"):
            continue
        out.append(qual(module, name))
        if name in mod.classes:
            out += [qual(module, name, m) for m in mod.public_api(name)]
    return out


def split(q: str):
    """(module, name, member or None) of a qualified JAX name."""
    for module in sorted(JAX_MODULES, key=len, reverse=True):
        prefix = module + "." if module else ""
        if q.startswith(prefix) and q != module:
            rest = q[len(prefix):].split(".")
            if len(rest) <= 2 and (rest[0] in JAX_MODULES[module].names
                                   or rest[0] in JAX_MODULES[module].exports):
                return module, rest[0], rest[1] if len(rest) == 2 else None
    raise KeyError(q)


def port_has(q: str) -> bool:
    module, name, member = split(q)
    port = PORT_MODULES.get(module)
    if port is None:
        return False
    if module == "" and name in JAX_MODULES[""].exports:
        return name in port.exports
    if member is None:
        return name in port.names
    return name in port.classes and member in port.members(name)


def row_of(q: str):
    """The NO_COUNTERPART row that covers q, if one does."""
    for key in NO_COUNTERPART:
        if q == key or q.startswith(key + "."):
            return key
    return None


API_MODULES = [m for m in sorted(JAX_MODULES) if jax_api(m)]


@pytest.mark.parametrize("module", API_MODULES, ids=lambda m: m or "package")
def test_every_jax_name_has_a_port_counterpart(module):
    missing = [q for q in jax_api(module)
               if not port_has(q) and row_of(q) is None]
    assert not missing, (
        f"videosys_tpu.{module or '__init__'} has names the port lacks (add "
        f"them to videosys_tpu_torch, or a row with its reason to "
        f"NO_COUNTERPART): {missing}")


def test_table_rows_name_jax_things_the_port_lacks():
    """Every row names a module or a public name of the JAX package, gives
    a reason, and still covers something the port has no counterpart of."""
    every = {q for m in JAX_MODULES for q in jax_api(m)}
    for key, reason in NO_COUNTERPART.items():
        assert isinstance(reason, str) and len(reason) > 10, key
        assert key in JAX_MODULES or key in every, \
            f"{key}: names nothing in videosys_tpu"
        covered = [q for q in every if row_of(q) == key]
        assert any(not port_has(q) for q in covered), \
            f"{key}: the port has every name this row covers; drop the row"


def test_last_ported_names_have_counterparts():
    """The names the port gained last are in no row and have their
    counterparts."""
    for q in PORTED_LAST:
        assert row_of(q) is None, q
        assert port_has(q), q
