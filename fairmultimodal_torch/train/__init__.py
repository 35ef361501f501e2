"""Trainers of the port: the FAME trainer and its protocol, threshold
calibration, the baselines' multitask trainer and 04's adversarial stage."""

from fairmultimodal_torch.train.adversarial import AdvConfig, adv_grid_search, train_adversarial
from fairmultimodal_torch.train.calibrate import calibrate_thresholds
from fairmultimodal_torch.train.loop import EarlyStopper, FAMETrainer, PlateauScheduler, TrainConfig
from fairmultimodal_torch.train.simple import MultitaskTrainer, SimpleTrainConfig

__all__ = [
    "TrainConfig",
    "PlateauScheduler",
    "EarlyStopper",
    "FAMETrainer",
    "calibrate_thresholds",
    "MultitaskTrainer",
    "SimpleTrainConfig",
    "AdvConfig",
    "adv_grid_search",
    "train_adversarial",
]
