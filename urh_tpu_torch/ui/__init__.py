"""The headless UI (PyTorch port of urh_tpu.ui): the undo stack, the
undoable actions, the table/list/tree models, the widget and dialog
controllers, the tab controllers (``ui.controllers``), the PNG writer, the
plots and the web app (``ui.web``, console script ``urh_tpu_torch-web``)."""
