"""glTF animation playback (reference: host_anim.cpp).

Numpy copy of lighthouse2_tpu/scene/host_anim.py (Sampler, Channel,
HostAnimation with from_gltf, update and apply), with no deliberate
difference. Samplers interpolate STEP / LINEAR / CUBICSPLINE
(host_anim.cpp:34-37, cubic evaluation :104-115); channels write a node's
translation, rotation, scale or morph weights (:190-251).
HostAnimation.update(scene, dt) advances the clock, looping, and poses.
"""
from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, times: np.ndarray, values: np.ndarray, interpolation: str):
        self.t = np.asarray(times, np.float32).reshape(-1)
        self.v = np.asarray(values, np.float32)
        self.interp = interpolation  # "STEP" | "LINEAR" | "CUBICSPLINE"

    def duration(self):
        return float(self.t[-1]) if self.t.size else 0.0

    def sample(self, time: float, stride: int = 1) -> np.ndarray:
        """Evaluate at `time`. For CUBICSPLINE, values are stored as
        (in-tangent, value, out-tangent) triplets per key."""
        t = self.t
        if t.size == 0:
            return None
        time = np.clip(time, t[0], t[-1])
        i = int(np.searchsorted(t, time, side="right") - 1)
        i = max(0, min(i, t.size - 2)) if t.size > 1 else 0
        if t.size == 1:
            return self.v[1] if self.interp == "CUBICSPLINE" else self.v[0]
        t0, t1 = float(t[i]), float(t[i + 1])
        f = 0.0 if t1 == t0 else (time - t0) / (t1 - t0)
        if self.interp == "STEP":
            return self.v[i]
        if self.interp == "CUBICSPLINE":
            # v layout: [key*3 + {0:in_tangent,1:value,2:out_tangent}]
            dt = t1 - t0
            p0 = self.v[3 * i + 1]
            m0 = self.v[3 * i + 2] * dt
            p1 = self.v[3 * (i + 1) + 1]
            m1 = self.v[3 * (i + 1)] * dt
            f2, f3 = f * f, f * f * f
            return ((2 * f3 - 3 * f2 + 1) * p0 + (f3 - 2 * f2 + f) * m0
                    + (-2 * f3 + 3 * f2) * p1 + (f3 - f2) * m1)
        # LINEAR (slerp-free nlerp for quaternions, like the reference)
        a, b = self.v[i], self.v[i + 1]
        out = (1 - f) * a + f * b
        return out


class Channel:
    TARGETS = {"translation": 0, "rotation": 1, "scale": 2, "weights": 3}

    def __init__(self, sampler_idx: int, node_id: int, target: str):
        self.sampler = sampler_idx
        self.node = node_id
        self.target = self.TARGETS[target]


class HostAnimation:
    def __init__(self, samplers, channels, name=""):
        self.samplers = samplers
        self.channels = channels
        self.name = name
        self.time = 0.0

    @staticmethod
    def from_gltf(g, aj, node_base):
        samplers = []
        for sj in aj.get("samplers", []):
            times = g.accessor(sj["input"]).reshape(-1)
            values = g.accessor(sj["output"])
            samplers.append(Sampler(times, values,
                                    sj.get("interpolation", "LINEAR")))
        channels = []
        for cj in aj.get("channels", []):
            tgt = cj["target"]
            if "node" not in tgt:
                continue
            channels.append(Channel(cj["sampler"], node_base + tgt["node"],
                                    tgt["path"]))
        return HostAnimation(samplers, channels, aj.get("name", ""))

    def duration(self):
        return max((s.duration() for s in self.samplers), default=0.0)

    def reset(self):
        self.time = 0.0

    def update(self, scene, dt: float):
        """Advance by dt seconds (looping) and pose the scene's nodes."""
        dur = self.duration()
        self.time = (self.time + dt) % dur if dur > 0 else 0.0
        self.apply(scene, self.time)

    def apply(self, scene, time: float):
        for ch in self.channels:
            s = self.samplers[ch.sampler]
            val = s.sample(time)
            if val is None:
                continue
            node = scene.nodes[ch.node]
            if ch.target == 0:
                node.translation = np.asarray(val, np.float32).reshape(3)
                node.has_trs = True
            elif ch.target == 1:
                q = np.asarray(val, np.float32).reshape(4)
                node.rotation = q / max(np.linalg.norm(q), 1e-20)
                node.has_trs = True
            elif ch.target == 2:
                node.scale = np.asarray(val, np.float32).reshape(3)
                node.has_trs = True
            elif ch.target == 3:
                node.morph_weights = np.asarray(val, np.float32).reshape(-1)
        scene.dirty = True
