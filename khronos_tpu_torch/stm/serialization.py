"""Serialization of scene graphs (`dsg.npz`).

Port of the scene-graph part of `khronos_tpu/stm/serialization.py`
(spark_dsg binary serialization + the reference's save layout,
backend.cpp:255-313). The archive is the JAX package's, key for key and
dtype for dtype (FORMAT_VERSION 1, the places layer included), so each
package reads what the other writes. The 4D-map archive (`.4dmap.npz`) is
built from these arrays by `stm/spatio_temporal_map.py`.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from khronos_tpu_torch.stm.scene_graph import AgentNode, KhronosObject, Mesh, SceneGraph

FORMAT_VERSION = 1


def _mesh_arrays(prefix: str, mesh: Mesh) -> Dict[str, np.ndarray]:
    return {
        f"{prefix}vertices": mesh.vertices,
        f"{prefix}colors": mesh.colors,
        f"{prefix}labels": mesh.labels,
        f"{prefix}first_seen_ns": mesh.first_seen_ns,
        f"{prefix}last_seen_ns": mesh.last_seen_ns,
        f"{prefix}faces": mesh.faces,
    }


def _mesh_from(prefix: str, data) -> Mesh:
    return Mesh(
        vertices=data[f"{prefix}vertices"],
        colors=data[f"{prefix}colors"],
        labels=data[f"{prefix}labels"],
        first_seen_ns=data[f"{prefix}first_seen_ns"],
        last_seen_ns=data[f"{prefix}last_seen_ns"],
        faces=data[f"{prefix}faces"],
    )


def scene_graph_arrays(dsg: SceneGraph, prefix: str = "") -> Dict[str, np.ndarray]:
    arrays = _mesh_arrays(f"{prefix}mesh/", dsg.mesh)
    arrays[f"{prefix}agents/stamps_ns"] = np.asarray(
        [a.stamp_ns for a in dsg.agents], np.int64
    )
    arrays[f"{prefix}agents/R"] = (
        np.stack([a.R_w_b for a in dsg.agents]).astype(np.float32)
        if dsg.agents
        else np.zeros((0, 3, 3), np.float32)
    )
    arrays[f"{prefix}agents/t"] = (
        np.stack([a.t_w_b for a in dsg.agents]).astype(np.float32)
        if dsg.agents
        else np.zeros((0, 3), np.float32)
    )
    arrays[f"{prefix}agents/keys"] = np.asarray([a.key for a in dsg.agents], np.int64)
    meta: List[dict] = []
    for oid, o in sorted(dsg.objects.items()):
        p = f"{prefix}objects/{oid}/"
        arrays[p + "mesh_vertices"] = o.mesh_vertices
        arrays[p + "mesh_faces"] = o.mesh_faces
        arrays[p + "mesh_colors"] = o.mesh_colors
        arrays[p + "trajectory_positions"] = np.asarray(
            o.trajectory_positions, np.float32
        ).reshape(-1, 3)
        arrays[p + "trajectory_stamps_ns"] = np.asarray(o.trajectory_stamps_ns, np.int64)
        arrays[p + "bbox"] = np.stack([o.bbox_min, o.bbox_max]).astype(np.float32)
        arrays[p + "presence"] = np.stack(
            [
                np.asarray(o.first_observed_ns, np.int64),
                np.asarray(o.last_observed_ns, np.int64),
            ]
        )
        if o.feature is not None:
            arrays[p + "feature"] = np.asarray(o.feature, np.float32)
        meta.append(
            {
                "node_id": o.node_id,
                "semantic_category": int(o.semantic_category),
                "confidence": float(o.confidence),
                "first_detected_ns": int(o.first_detected_ns),
            }
        )
    arrays[f"{prefix}objects_meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    if dsg.places is not None and dsg.places.nodes:
        pl = dsg.places
        arrays[f"{prefix}places/positions"] = np.stack([n.position for n in pl.nodes]).astype(np.float32)
        arrays[f"{prefix}places/distances"] = np.asarray([n.distance for n in pl.nodes], np.float32)
        arrays[f"{prefix}places/room_ids"] = np.asarray([n.room_id for n in pl.nodes], np.int32)
        arrays[f"{prefix}places/edges"] = (
            np.asarray(pl.edges, np.float32) if pl.edges else np.zeros((0, 3), np.float32)
        )
    return arrays


def scene_graph_from_arrays(data, prefix: str = "") -> SceneGraph:
    dsg = SceneGraph(mesh=_mesh_from(f"{prefix}mesh/", data))
    stamps = data[f"{prefix}agents/stamps_ns"]
    Rs = data[f"{prefix}agents/R"]
    ts = data[f"{prefix}agents/t"]
    keys = data[f"{prefix}agents/keys"]
    for i in range(len(stamps)):
        dsg.agents.append(AgentNode(int(stamps[i]), Rs[i], ts[i], int(keys[i])))
    meta = json.loads(bytes(data[f"{prefix}objects_meta"]).decode())
    for m in meta:
        oid = m["node_id"]
        p = f"{prefix}objects/{oid}/"
        bbox = data[p + "bbox"]
        presence = data[p + "presence"]
        feature = data[p + "feature"] if (p + "feature") in data else None
        dsg.objects[oid] = KhronosObject(
            node_id=oid,
            semantic_category=m["semantic_category"],
            bbox_min=bbox[0],
            bbox_max=bbox[1],
            first_observed_ns=presence[0].tolist(),
            last_observed_ns=presence[1].tolist(),
            mesh_vertices=data[p + "mesh_vertices"],
            mesh_faces=data[p + "mesh_faces"],
            mesh_colors=data[p + "mesh_colors"],
            trajectory_stamps_ns=data[p + "trajectory_stamps_ns"].tolist(),
            trajectory_positions=data[p + "trajectory_positions"],
            feature=feature,
            confidence=m["confidence"],
            first_detected_ns=int(m.get("first_detected_ns", -1)),
        )
    if f"{prefix}places/positions" in data:
        from khronos_tpu_torch.stm.places import PlaceNode, PlacesLayer

        pl = PlacesLayer()
        pos = data[f"{prefix}places/positions"]
        dist = data[f"{prefix}places/distances"]
        rooms = data[f"{prefix}places/room_ids"]
        for i in range(len(pos)):
            pl.nodes.append(PlaceNode(i, pos[i], float(dist[i]), int(rooms[i])))
        pl.edges = [(int(a), int(b), float(c)) for a, b, c in data[f"{prefix}places/edges"]]
        dsg.places = pl
    return dsg


def save_scene_graph(dsg: SceneGraph, path: str) -> None:
    arrays = scene_graph_arrays(dsg)
    arrays["format_version"] = np.asarray([FORMAT_VERSION])
    np.savez_compressed(path, **arrays)


def load_scene_graph(path: str) -> SceneGraph:
    with np.load(path, allow_pickle=False) as data:
        version = int(data["format_version"][0])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported dsg format version {version}")
        return scene_graph_from_arrays(data)


def save_mesh_ply(mesh: Mesh, path: str) -> None:
    """ASCII PLY export (mesh.ply parity with the reference save layout)."""
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {mesh.num_vertices}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fh.write(f"element face {mesh.num_faces}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        cols = np.clip(mesh.colors * 255, 0, 255).astype(np.uint8)
        for v, c in zip(mesh.vertices, cols):
            fh.write(f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
        for f in mesh.faces:
            fh.write(f"3 {f[0]} {f[1]} {f[2]}\n")
