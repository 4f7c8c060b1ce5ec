"""Hyperparameter-tuning hooks of the port.

Port of ``xgboost_ray_tpu/tune.py:47-240`` (``xgboost_ray/tune.py``): a
report/checkpoint callback that ``train()`` adds when it runs inside a
tuning session (``_try_add_tune_callback``), the trial's resources
(``PlacementGroupFactory``, ``_get_tune_resources``) and ``load_model`` of
a checkpoint. The session is the standalone one of the JAX package
(``TuneSession``: results, checkpoints, an optional trial scheduler
consulted on every report); the JAX module's ``ray.tune`` branch has no
counterpart (ray is installed nowhere the port runs). The Tuner that runs
trials (``tuner.py``) is ROADMAP A19.
"""

import dataclasses
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional

from xgboost_ray_tpu_torch.callback import TrainingCallback
from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster

# thread-local: concurrent trials, one training a thread, keep their own
_session_tls = threading.local()


class TuneSession:
    """Trial-side context collecting reported results and checkpoints."""

    def __init__(self, trial_dir: Optional[str] = None):
        self.trial_dir = trial_dir or tempfile.mkdtemp(prefix="rxgb_trial_")
        self.results: List[Dict[str, Any]] = []
        self.last_checkpoint_path: Optional[str] = None
        # a trial scheduler (``on_report(trial_id, iteration, metrics)``),
        # consulted on every report; True stops the trial's training
        self.scheduler = None
        self.trial_id: Optional[str] = None
        self.stopped_by_scheduler = False

    def report(self, metrics: Dict[str, Any],
               checkpoint_path: Optional[str] = None) -> bool:
        """Record a result; True when the scheduler stops the trial."""
        self.results.append(dict(metrics))
        if checkpoint_path:
            self.last_checkpoint_path = checkpoint_path
        if self.scheduler is None:
            return False
        stop = bool(self.scheduler.on_report(
            self.trial_id or "trial",
            int(metrics.get("training_iteration", len(self.results))),
            metrics))
        if stop:
            self.stopped_by_scheduler = True
        return stop


def init_session(trial_dir: Optional[str] = None) -> TuneSession:
    _session_tls.value = TuneSession(trial_dir)
    return _session_tls.value


def shutdown_session():
    _session_tls.value = None


def get_session() -> Optional[TuneSession]:
    return getattr(_session_tls, "value", None)


def is_session_enabled() -> bool:
    """Inside a tuning trial? (``xgboost_ray/tune.py:61-64``)."""
    return get_session() is not None


class TuneReportCheckpointCallback(TrainingCallback):
    """Per-iteration metric report and a checkpoint every ``frequency``
    rounds into the trial directory. ``metrics`` maps reported names to
    eval-result keys ("{set}-{metric}"); by default every recorded metric
    is reported."""

    def __init__(self, metrics: Optional[Any] = None,
                 filename: str = "checkpoint.json", frequency: int = 5):
        if isinstance(metrics, str):
            metrics = [metrics]
        self._metrics = metrics
        self._filename = filename
        self._frequency = max(1, int(frequency))

    @staticmethod
    def _flatten(evals_log: Dict) -> Dict[str, float]:
        flat = {}
        for set_name, metric_dict in (evals_log or {}).items():
            for metric_name, values in metric_dict.items():
                if values:
                    flat[f"{set_name}-{metric_name}"] = values[-1]
        return flat

    def after_iteration(self, model, epoch: int, evals_log: Dict) -> bool:
        session = get_session()
        if session is None:
            return False
        flat = self._flatten(evals_log)
        if self._metrics is None:
            report = dict(flat)
        elif isinstance(self._metrics, dict):
            report = {out: flat.get(src) for out, src in self._metrics.items()}
        else:
            report = {m: flat.get(m) for m in self._metrics}
        report["training_iteration"] = epoch + 1
        checkpoint_path = None
        if (epoch + 1) % self._frequency == 0:
            checkpoint_path = os.path.join(session.trial_dir,
                                           f"checkpoint_{epoch + 1:06d}")
            os.makedirs(checkpoint_path, exist_ok=True)
            model.save_model(os.path.join(checkpoint_path, self._filename))
        # the scheduler's decision: True stops this trial's training
        return session.report(report, checkpoint_path=checkpoint_path)


class TuneReportCallback(TuneReportCheckpointCallback):
    """Reports every round and never checkpoints (the reference's alias)."""

    def __init__(self, metrics: Optional[Any] = None):
        super().__init__(metrics=metrics, frequency=1 << 30)


def _try_add_tune_callback(callbacks: List) -> List:
    """Inside a tuning session, add a report callback unless one is there
    (``xgboost_ray/tune.py:60-104``)."""
    if not is_session_enabled():
        return callbacks
    if not any(isinstance(cb, TuneReportCheckpointCallback) for cb in callbacks):
        callbacks = list(callbacks) + [TuneReportCheckpointCallback()]
    return callbacks


@dataclasses.dataclass
class PlacementGroupFactory:
    """Tune's PlacementGroupFactory: a head bundle plus one bundle per
    actor, PACK strategy (``xgboost_ray/tune.py:107-126``)."""

    bundles: List[Dict[str, float]]
    strategy: str = "PACK"
    # other placement options, carried through verbatim
    options: dict = dataclasses.field(default_factory=dict)

    def required_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for bundle in self.bundles:
            for key, val in bundle.items():
                total[key] = total.get(key, 0.0) + val
        return total


def _get_tune_resources(
    num_actors: int,
    cpus_per_actor: int,
    gpus_per_actor: int,
    tpus_per_actor: int,
    resources_per_actor: Optional[Dict],
    placement_options: Optional[Dict],
) -> PlacementGroupFactory:
    head = {"CPU": 1.0}
    child: Dict[str, float] = {"CPU": float(cpus_per_actor)}
    if gpus_per_actor:
        child["GPU"] = float(gpus_per_actor)
    if tpus_per_actor:
        child["TPU"] = float(tpus_per_actor)
    if resources_per_actor:
        child.update({k: float(v) for k, v in resources_per_actor.items()})
    options = dict(placement_options or {})
    strategy = options.pop("strategy", "PACK")
    return PlacementGroupFactory(
        bundles=[head] + [dict(child) for _ in range(num_actors)],
        strategy=strategy,
        options=options,
    )


def load_model(model_path: str) -> RayXGBoostBooster:
    """Load a model the tune callback saved (a file, or the first ``.json``
    of a checkpoint directory; ``xgboost_ray/tune.py:130-156``)."""
    if os.path.isdir(model_path):
        for name in sorted(os.listdir(model_path)):
            if name.endswith(".json"):
                model_path = os.path.join(model_path, name)
                break
    return RayXGBoostBooster.load_model(model_path)
