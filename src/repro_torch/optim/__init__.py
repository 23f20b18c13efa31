from repro_torch.optim.fo import (
    FOTrainState,
    Optimizer,
    adamw,
    build_fo_train_step,
    init_fo_state,
    sgd,
)
