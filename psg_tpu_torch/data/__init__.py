"""Data layer: the caption CSV and sprites (``dataset``), host augmentation
(``augment``, and the native engine ``native``), caption variants
(``caption_augment``), the training loader (``loader``), and a small corpus
made from a seed for tests and smoke runs (``synthetic``).  Importing the
package loads none of them."""
