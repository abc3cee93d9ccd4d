"""Front-end tracker, MSCKF filter and the VIO step that joins them."""
