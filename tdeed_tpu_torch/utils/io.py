"""JSON IO + SoccerNet results writers (ref: util/io.py).

The port's own copy of ``tdeed_tpu/utils/io.py`` (held equal by
tests/test_torch_infer_copies.py)."""

from __future__ import annotations

import json
import os
from typing import Any, List

from tdeed_tpu_torch.data.registry import FPS_SN  # single source (ref: dataset/frame.py:27)


def load_json(path: str) -> Any:
    with open(path) as fp:
        return json.load(fp)


def store_json(path: str, obj: Any, pretty: bool = False) -> None:
    kwargs = {"indent": 2, "sort_keys": True} if pretty else {}
    with open(path, "w") as fp:
        json.dump(obj, fp, **kwargs)


def _event_to_prediction(event: dict, half: int, stride: int) -> dict:
    position = int(event["frame"] / FPS_SN * 1000 * stride)
    return {
        "gameTime": "{} - {}:{}".format(
            half, position // 60000, int((position % 60000) // 1000)
        ),
        "label": event["label"],
        "position": position,
        "confidence": event["score"],
        "half": half,
    }


def store_json_sn(pred_path: str, pred: List[dict], stride: int = 1) -> None:
    """Per-game results_spotting.json pairing halves 1/2 (ref: util/io.py:22-47)."""
    for i, game in enumerate(pred):
        if i % 2 == 0:
            game_dict = {"UrlLocal": game["video"], "predictions": []}
        half = (i % 2) + 1
        for event in game["events"]:
            game_dict["predictions"].append(_event_to_prediction(event, half, stride))
        if i % 2 == 1:
            path = os.path.join(
                "/".join(pred_path.split("/")[:-1]) + "/preds",
                "/".join(game["video"].split("/")[:-1]),
            )
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "results_spotting.json"), "w") as fp:
                json.dump(game_dict, fp, indent=4)


def store_json_snb(pred_path: str, pred: List[dict], stride: int = 1) -> None:
    """Single-half SNB variant (ref: util/io.py:49-68)."""
    for game in pred:
        game_dict = {"UrlLocal": game["video"], "predictions": []}
        for event in game["events"]:
            game_dict["predictions"].append(_event_to_prediction(event, 1, stride))
        path = os.path.join(
            "/".join(pred_path.split("/")[:-1]) + "/preds", game["video"]
        )
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "results_spotting.json"), "w") as fp:
            json.dump(game_dict, fp, indent=4)
