"""Data layer: the caption CSV and sprites (``dataset``), and a small corpus
made from a seed for tests and smoke runs (``synthetic``).  Importing the
package loads neither module."""
