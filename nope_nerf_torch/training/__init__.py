from .state import ModelConfigs, TrainState, create_train_state
from .trainer import Trainer, compute_step_loss, train_step
