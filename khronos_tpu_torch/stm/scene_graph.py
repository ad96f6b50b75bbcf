"""Scene-graph data model: objects, agents, background mesh with stamps.

Equivalent of the reference's spark_dsg DynamicSceneGraph usage (SURVEY.md
§2.3): layered nodes (AGENTS / OBJECTS) with `KhronosObjectAttributes`
{mesh, bbox, first/last_observed_ns vectors, trajectory, semantic feature}
(common_types.h:118-127) and a background `Mesh` with per-vertex
first_seen/last_seen stamps (ray_verificator.cpp:219-236). Host-side numpy
structures; device kernels consume flat array views.

Stamps are int64 nanoseconds.

Host copy of `khronos_tpu/stm/scene_graph.py`. `SceneGraph.places` holds a
`stm.places.PlacesLayer` when the pipeline builds one. `MeshAccumulator` is the plain version of
the native accumulator (`khronos_tpu_torch/native.py`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh with per-vertex observation stamps."""

    vertices: np.ndarray  # [V, 3] float32
    colors: np.ndarray  # [V, 3] float32
    labels: np.ndarray  # [V] int32
    first_seen_ns: np.ndarray  # [V] int64
    last_seen_ns: np.ndarray  # [V] int64
    faces: np.ndarray  # [F, 3] int64

    @staticmethod
    def empty() -> "Mesh":
        return Mesh(
            vertices=np.zeros((0, 3), np.float32),
            colors=np.zeros((0, 3), np.float32),
            labels=np.zeros((0,), np.int32),
            first_seen_ns=np.zeros((0,), np.int64),
            last_seen_ns=np.zeros((0,), np.int64),
            faces=np.zeros((0, 3), np.int64),
        )

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    def clone(self, share_arrays: bool = False) -> "Mesh":
        """share_arrays=True returns a new Mesh OBJECT referencing the same
        (treat-as-immutable) arrays — for consumers that rebind fields to
        fresh arrays (finalize/sort) without copying ~100 MB first."""
        if share_arrays:
            return Mesh(**{f.name: getattr(self, f.name) for f in dataclasses.fields(self)})
        return Mesh(**{f.name: getattr(self, f.name).copy() for f in dataclasses.fields(self)})


class MeshAccumulator:
    """Builds an indexed Mesh from triangle soup with vertex deduplication.

    Equivalent of kimera_pgmo's mesh compression (SURVEY.md §2.3,
    `mesh_resolution: 0.005`): vertices are deduplicated on a quantization
    grid; re-added vertices extend their last_seen stamp (and keep the
    earliest first_seen), which is exactly the stamp semantics the ray
    verificator needs.
    """

    def __init__(self, resolution: float = 0.005):
        self.resolution = resolution
        self._index: Dict[Tuple[int, int, int], int] = {}
        self.vertices: List[np.ndarray] = []
        self.colors: List[np.ndarray] = []
        self.labels: List[int] = []
        self.first_seen: List[int] = []
        self.last_seen: List[int] = []
        self.faces: List[Tuple[int, int, int]] = []

    def add_triangles(
        self,
        tri_vertices: np.ndarray,  # [T, 3, 3]
        tri_colors: np.ndarray,  # [T, 3, 3]
        tri_first_ns: np.ndarray,  # [T, 3]
        tri_last_ns: np.ndarray,  # [T, 3]
        tri_labels: np.ndarray,  # [T, 3]
    ) -> int:
        """Returns number of new vertices created."""
        if len(tri_vertices) == 0:
            return 0
        created = 0
        q = np.round(tri_vertices / self.resolution).astype(np.int64)
        for t in range(len(tri_vertices)):
            ids = []
            for k in range(3):
                key = (int(q[t, k, 0]), int(q[t, k, 1]), int(q[t, k, 2]))
                vid = self._index.get(key)
                if vid is None:
                    vid = len(self.vertices)
                    self._index[key] = vid
                    self.vertices.append(tri_vertices[t, k])
                    self.colors.append(tri_colors[t, k])
                    self.labels.append(int(tri_labels[t, k]))
                    self.first_seen.append(int(tri_first_ns[t, k]))
                    self.last_seen.append(int(tri_last_ns[t, k]))
                    created += 1
                else:
                    self.first_seen[vid] = min(self.first_seen[vid], int(tri_first_ns[t, k]))
                    self.last_seen[vid] = max(self.last_seen[vid], int(tri_last_ns[t, k]))
                ids.append(vid)
            if ids[0] != ids[1] and ids[1] != ids[2] and ids[0] != ids[2]:
                self.faces.append((ids[0], ids[1], ids[2]))
        return created

    def build(self) -> Mesh:
        if not self.vertices:
            return Mesh.empty()
        return Mesh(
            vertices=np.asarray(self.vertices, np.float32),
            colors=np.asarray(self.colors, np.float32),
            labels=np.asarray(self.labels, np.int32),
            first_seen_ns=np.asarray(self.first_seen, np.int64),
            last_seen_ns=np.asarray(self.last_seen, np.int64),
            faces=np.asarray(self.faces, np.int64) if self.faces else np.zeros((0, 3), np.int64),
        )


@dataclasses.dataclass
class KhronosObject:
    """Mirrors spark_dsg KhronosObjectAttributes (common_types.h:118-127)."""

    node_id: int
    semantic_category: int
    bbox_min: np.ndarray  # [3] world frame
    bbox_max: np.ndarray
    # presence intervals (sorted, ns). After reconciliation these hold the
    # ESTIMATED presence (may start before the robot ever saw the object).
    first_observed_ns: List[int]
    last_observed_ns: List[int]
    # object mesh in bbox frame (vertices relative to bbox_min)
    mesh_vertices: np.ndarray  # [V, 3]
    mesh_faces: np.ndarray  # [F, 3]
    mesh_colors: np.ndarray  # [V, 3]
    # dynamic objects: centroid trajectory
    trajectory_stamps_ns: List[int] = dataclasses.field(default_factory=list)
    trajectory_positions: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.float32)
    )
    feature: Optional[np.ndarray] = None  # open-set embedding
    confidence: float = 1.0
    # when the robot FIRST detected the object (knowledge time) — stays fixed
    # when reconciliation rewrites first_observed_ns to an estimated presence
    # start (reference keys robot-time visibility on explicit first-observed,
    # spatio_temporal_map.cpp:244-293); -1 = not yet reconciled, use
    # first_observed_ns[0]
    first_detected_ns: int = -1

    @property
    def is_dynamic(self) -> bool:
        return len(self.trajectory_stamps_ns) > 0

    def detected_ns(self) -> int:
        """Robot knowledge time: when the object was first actually seen."""
        if self.first_detected_ns >= 0:
            return self.first_detected_ns
        return self.first_observed_ns[0] if self.first_observed_ns else 0

    def position(self) -> np.ndarray:
        return 0.5 * (self.bbox_min + self.bbox_max)

    def world_mesh_vertices(self) -> np.ndarray:
        return self.mesh_vertices + self.bbox_min

    def clone(self) -> "KhronosObject":
        return copy.deepcopy(self)


@dataclasses.dataclass
class AgentNode:
    stamp_ns: int
    R_w_b: np.ndarray  # [3,3]
    t_w_b: np.ndarray  # [3]
    key: int = 0  # pose-graph key


@dataclasses.dataclass
class SceneGraph:
    """The DSG: background mesh + object nodes + agent trajectory + places."""

    mesh: Mesh = dataclasses.field(default_factory=Mesh.empty)
    objects: Dict[int, KhronosObject] = dataclasses.field(default_factory=dict)
    agents: List[AgentNode] = dataclasses.field(default_factory=list)
    places: object = None  # stm.places.PlacesLayer (optional layer)

    def clone(self, share_arrays: bool = False) -> "SceneGraph":
        return SceneGraph(
            mesh=self.mesh.clone(share_arrays=share_arrays),
            objects={k: v.clone() for k, v in self.objects.items()},
            agents=[AgentNode(a.stamp_ns, a.R_w_b.copy(), a.t_w_b.copy(), a.key) for a in self.agents],
            places=copy.deepcopy(self.places),
        )

    def add_object(self, obj: KhronosObject):
        self.objects[obj.node_id] = obj

    def agent_stamps(self) -> np.ndarray:
        return np.asarray([a.stamp_ns for a in self.agents], np.int64)

    def agent_positions(self) -> np.ndarray:
        if not self.agents:
            return np.zeros((0, 3), np.float32)
        return np.stack([a.t_w_b for a in self.agents]).astype(np.float32)
