from .tum import AteResult, associate, evaluate_ate, horn_align, read_tum, write_tum
