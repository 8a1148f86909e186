"""Headless edit session: the live-edit loop of the reference editor.

In the reference every ImGui edit mutates live engine state AND immediately
rewrites the backing JSON (Core/Transform.cpp:29-49, Core/LightTransform.cpp
:33-52, Core/UserInterface.cpp:363-368, Core/Camera.cpp:178-192); the JSON
files are the persistent store. ``EditSession`` binds the same contract
headlessly:

  * ``edit_object`` — move/rotate/scale an instance: refreshes the TLAS +
    shading slices in place (``rebuild_scene``, O(moved)) and writes the
    GameObject JSON back;
  * ``edit_light`` / ``edit_camera`` — update live state + JSON write-back;
  * ``render``/``capture`` — the render side of the loop;
  * ``watch_once`` — reverse direction: detect on-disk JSON edits (an
    external editor playing the role of the UI) and fold them into the live
    scene, so ``while True: session.watch_once(); session.capture()`` is a
    complete headless editor loop.

Driven by ``cli.py --session`` (stdin command loop) and tested in
tests/test_session.py.
"""

from __future__ import annotations

import os
from dataclasses import replace as dc_replace

import numpy as np

from physically_based_ray_tracer_tpu.config import RenderConfig
from physically_based_ray_tracer_tpu.render.renderer import Renderer
from physically_based_ray_tracer_tpu.scene.camera import Camera
from physically_based_ray_tracer_tpu.scene.lights import LightSet
from physically_based_ray_tracer_tpu.scene.loader import load_reference_scene
from physically_based_ray_tracer_tpu.scene.scene import rebuild_scene
from physically_based_ray_tracer_tpu.scene.serialization import (
    load_camera_json, load_gameobject_json, save_camera_json,
    save_gameobject_json, save_light_json)

_LIGHT_DIRS = {"point": "pointlights", "directional": "directionallights",
               "spot": "spotlights"}


class EditSession:
    """Live edit-render session over a reference-format asset tree."""

    def __init__(self, assets_root: str, scene_name: str = "scene1",
                 cfg: RenderConfig | None = None, **load_kw):
        self.assets_root = assets_root
        self.scene_dir = os.path.join(assets_root, scene_name)
        scene, cam, depth, handle = load_reference_scene(
            assets_root, scene_name, return_handle=True, **load_kw)
        assert handle is not None
        self.handle = handle
        self._include_point_lights = load_kw.get("include_point_lights", True)
        self.cfg = cfg or RenderConfig(
            width=256, height=256, bounces=2,
            max_stack_depth=max(depth + 2, 32), skybox=False)
        self.renderer = Renderer(scene, cam, self.cfg)
        self._mtimes = self._scan_mtimes()

    # -- paths -------------------------------------------------------------
    def _object_path(self, name: str) -> str:
        return os.path.join(self.scene_dir, f"{name}.json")

    def _light_path(self, kind: str, index: int) -> str:
        # filter to .json exactly like the loader does, so the index↔file
        # mapping cannot be shifted by stray editor backups
        d = os.path.join(self.scene_dir, _LIGHT_DIRS[kind])
        files = (sorted(f for f in os.listdir(d) if f.endswith(".json"))
                 if os.path.isdir(d) else [])
        if index < len(files):
            return os.path.join(d, files[index])
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{kind}{index}.json")

    def _camera_path(self) -> str:
        return os.path.join(self.assets_root, "prefabs/camera.json")

    # -- edits (live state + JSON write-back, the UI contract) -------------
    def edit_object(self, name: str, position=None, rotation=None, scale=None):
        """Transform edit: TLAS/shading refresh + GameObject JSON rewrite
        (Core/Transform.cpp:29-49 write-on-edit)."""
        insts = list(self.handle.instances)
        idx = next(i for i, it in enumerate(insts) if it.name == name)
        it = insts[idx]
        insts[idx] = dc_replace(
            it,
            position=tuple(position) if position is not None else it.position,
            rotation=tuple(rotation) if rotation is not None else it.rotation,
            scale=tuple(scale) if scale is not None else it.scale)
        self.renderer.scene = rebuild_scene(self.renderer.scene, self.handle,
                                            insts)
        save_gameobject_json(self._object_path(name), insts[idx])
        self.renderer.reset_accumulation()

    def edit_light(self, kind: str, index: int, position=None, color=None,
                   rotation=None):
        """Light edit: LightSet rebuild + JSON rewrite (the Lights-tab
        semantics, Core/UserInterface.cpp:363-368)."""
        L = self.renderer.scene.lights
        arrays = {k: np.array(getattr(L, k)) for k in
                  ("point_pos", "point_color", "point_active",
                   "dir_pos", "dir_color", "spot_pos", "spot_color",
                   "spot_rot", "area_pos", "area_color", "area_u", "area_v")}
        pre = {"point": "point", "directional": "dir", "spot": "spot"}[kind]
        if position is not None:
            arrays[f"{pre}_pos"][index] = position
        if color is not None:
            arrays[f"{pre}_color"][index] = color
        if rotation is not None and kind == "spot":
            arrays["spot_rot"][index] = rotation
        import jax.numpy as jnp
        self.renderer.scene = self.renderer.scene._replace(
            lights=L._replace(**{k: jnp.asarray(v)
                                 for k, v in arrays.items()}))
        save_light_json(self._light_path(kind, index),
                        arrays[f"{pre}_pos"][index],
                        arrays[f"{pre}_color"][index],
                        arrays["spot_rot"][index] if kind == "spot"
                        else (0.0, 0.0, 0.0))
        self.renderer.reset_accumulation()

    def edit_camera(self, pos=None, target=None):
        """Fly-cam edit + camera.json persistence (Core/Camera.cpp:178-192)."""
        cam = self.renderer.camera
        new = Camera.make(pos=pos if pos is not None else np.asarray(cam.pos),
                          target=(target if target is not None
                                  else np.asarray(cam.target)))
        self.renderer.camera = new
        save_camera_json(self._camera_path(), new)
        self.renderer.reset_accumulation()

    # -- render ------------------------------------------------------------
    def render(self, samples: int = 1):
        return self.renderer.render(samples=samples)

    def capture(self, path: str | None = None) -> str:
        return self.renderer.capture(path)

    # -- external-edit watcher (disk -> live state) ------------------------
    def _scan_mtimes(self):
        out = {}
        for f in sorted(os.listdir(self.scene_dir)):
            p = os.path.join(self.scene_dir, f)
            if f.endswith(".json") and os.path.isfile(p):
                out[p] = os.path.getmtime(p)
        # light subdirectories too, so external light-JSON edits are folded
        # in by watch_once just like object/camera edits
        for sub in _LIGHT_DIRS.values():
            d = os.path.join(self.scene_dir, sub)
            if os.path.isdir(d):
                for f in sorted(os.listdir(d)):
                    if f.endswith(".json"):
                        p = os.path.join(d, f)
                        out[p] = os.path.getmtime(p)
        cp = self._camera_path()
        if os.path.exists(cp):
            out[cp] = os.path.getmtime(cp)
        return out

    def watch_once(self) -> list[str]:
        """Fold any externally edited scene JSONs into the live scene.
        Returns the list of changed files (empty = nothing to do)."""
        now = self._scan_mtimes()
        changed = [p for p, t in now.items()
                   if self._mtimes.get(p) != t]
        self._mtimes = now
        if not changed:
            return []
        insts = list(self.handle.instances)
        reload_objects = reload_lights = False
        light_dirs = {os.path.join(self.scene_dir, s)
                      for s in _LIGHT_DIRS.values()}
        for p in changed:
            if p == self._camera_path():
                self.renderer.camera = load_camera_json(p)
                continue
            if os.path.dirname(p) in light_dirs:
                reload_lights = True
                continue
            name = os.path.splitext(os.path.basename(p))[0]
            for i, it in enumerate(insts):
                if it.name == name:
                    insts[i] = load_gameobject_json(p)
                    reload_objects = True
        if reload_lights:
            from physically_based_ray_tracer_tpu.scene.serialization import \
                load_scene_dir
            _, lights = load_scene_dir(
                self.scene_dir,
                include_point_lights=self._include_point_lights)
            self.renderer.scene = self.renderer.scene._replace(
                lights=lights.pad_points(4))
        if reload_objects:
            self.renderer.scene = rebuild_scene(self.renderer.scene,
                                                self.handle, insts)
        self.renderer.reset_accumulation()
        return changed
