"""Binary CLV store: dump/load the full reference-tree placement state
(``--dump-binary`` / ``-b``).

Equivalent of the reference's --dump-binary / -b machinery
(src/io/Binary.cpp): a preprocessing run builds the edge CLV tensors once and
serializes them; placement runs then load them straight onto the device
without touching the reference MSA.

Format (v3), the JAX package's own, so that a store written by either
package loads in the other: a single .npz holding the edge tensors, the
original newick text (re-parsed on load so edge numbering and rooted-tree
mapping are rebuilt identically), and the model AS RESOLVED ARRAYS — every
family round-trips exactly (DNA, protein, BIN, diploid10, matrix mixtures,
+ASC, free rates), unlike a descriptor-string reconstruction which cannot
express mixtures or the 2/10-state rate counts (the reference serializes the
pll partition's numeric arrays the same way, src/io/Binary.cpp:211-287).
"""

from __future__ import annotations

import numpy as np

_MODEL_VERSION = 3


def _model_to_arrays(model) -> dict:
    """The model's evaluation-relevant state as flat npz-able arrays."""
    out = {
        "m_name": np.array(model.name),
        "m_data_type": np.array(model.data_type.value),
        "m_num_states": np.array(model.num_states),
        "m_subst_rates": np.asarray(model.subst_rates, np.float64),
        "m_base_freqs": np.asarray(model.base_freqs, np.float64),
        "m_alpha": np.array(float(model.alpha)),
        "m_pinv": np.array(float(model.pinv)),
        "m_num_ratecats": np.array(int(model.num_ratecats)),
        "m_gamma_mode": np.array(model.gamma_mode),
        "m_rate_het": np.array(model.rate_het),
        "m_rate_sym": np.array(model.rate_sym or ""),
        "m_gt_dna_sym": np.array(model.gt_dna_sym or ""),
        "m_ascbias_type": np.array(model.ascbias_type or ""),
    }
    if model.ratecat_rates is not None:
        out["m_ratecat_rates"] = np.asarray(model.ratecat_rates, np.float64)
        out["m_ratecat_weights"] = np.asarray(model.ratecat_weights,
                                              np.float64)
    if model.ascbias_weights is not None:
        out["m_ascbias_weights"] = np.asarray(model.ascbias_weights,
                                              np.float64)
    if model.submodels is not None:
        out["m_sub_rates"] = np.stack(
            [np.asarray(r, np.float64) for r, _ in model.submodels])
        out["m_sub_freqs"] = np.stack(
            [np.asarray(f, np.float64) for _, f in model.submodels])
    return out


def _model_from_arrays(data):
    from epa_ng_tpu_torch.models.model import DataType, Model, ParamValue
    m = Model()
    m.name = str(data["m_name"])
    m.data_type = DataType(str(data["m_data_type"]))
    m.num_states = int(data["m_num_states"])
    m.subst_rates = np.asarray(data["m_subst_rates"])
    m.base_freqs = np.asarray(data["m_base_freqs"])
    m.alpha = float(data["m_alpha"])
    m.pinv = float(data["m_pinv"])
    m.num_ratecats = int(data["m_num_ratecats"])
    m.gamma_mode = str(data["m_gamma_mode"])
    m.rate_het = str(data["m_rate_het"])
    m.rate_sym = str(data["m_rate_sym"]) or None
    m.gt_dna_sym = str(data["m_gt_dna_sym"]) or None
    m.ascbias_type = str(data["m_ascbias_type"]) or None
    if "m_ratecat_rates" in data:
        m.ratecat_rates = np.asarray(data["m_ratecat_rates"])
        m.ratecat_weights = np.asarray(data["m_ratecat_weights"])
    if "m_ascbias_weights" in data:
        m.ascbias_weights = np.asarray(data["m_ascbias_weights"])
    if "m_sub_rates" in data:
        sub_r = np.asarray(data["m_sub_rates"])
        sub_f = np.asarray(data["m_sub_freqs"])
        m.submodels = [(sub_r[i], sub_f[i]) for i in range(sub_r.shape[0])]
    # every parameter is pinned to the stored values
    m.freqs_mode = ParamValue.USER
    m.rates_mode = ParamValue.USER
    return m


def dump_binary(engine, path: str, tree_newick_text: str):
    """Write ``engine``'s edge tensors (kept by ``dump_binary_mode``) and
    model to ``path`` (``.npz`` is appended)."""
    et = engine.edges
    host = lambda t: t.detach().cpu().numpy()
    inter = (engine._ref_intersection if engine._ref_intersection is not None
             else np.zeros(0, dtype=np.uint32))
    np.savez_compressed(
        path,
        U=host(et.U), V=host(et.V), lsU=host(et.lsU), lsV=host(et.lsV),
        lengths=host(et.lengths),
        tree_newick=np.array(tree_newick_text),
        ref_intersection=inter,
        num_sites=np.array(engine.num_sites),
        format_version=np.array(_MODEL_VERSION),
        **_model_to_arrays(engine.model))


def load_binary(path: str, options=None, engine_cls=None, device="cuda"):
    """Rebuild a PlacementEngine on ``device`` from a dumped CLV store."""
    from epa_ng_tpu_torch.core.engine import PlacementEngine
    from epa_ng_tpu_torch.ops.clv import EdgeTensors
    from epa_ng_tpu_torch.tree import Tree
    from epa_ng_tpu_torch.utils.options import Options

    if engine_cls is None:
        engine_cls = PlacementEngine
    data = np.load(path, allow_pickle=False)
    version = int(data["format_version"]) if "format_version" in data else 0
    if version != _MODEL_VERSION:
        raise ValueError(
            f"{path}: binary CLV store format v{version} is not supported "
            f"by this build (expected v{_MODEL_VERSION}) — re-run "
            "--dump-binary")
    options = options or Options()
    tree = Tree.from_string(str(data["tree_newick"]),
                            preserve_rooting=options.preserve_rooting)
    model = _model_from_arrays(data)
    edges = EdgeTensors(U=data["U"], V=data["V"], lsU=data["lsU"],
                        lsV=data["lsV"], lengths=data["lengths"])
    inter = data["ref_intersection"]
    return engine_cls.from_precomputed(
        tree=tree, model=model, options=options, edges=edges,
        num_sites=int(data["num_sites"]),
        ref_intersection=(inter if inter.size else None), device=device)
