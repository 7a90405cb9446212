"""The headless UI's model layer (PyTorch port of urh_tpu.ui): the undo
stack, the undoable actions, the table/list/tree models, the widget
controllers, the PNG writer and the plots."""
