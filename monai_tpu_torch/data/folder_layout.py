"""Where an output file goes (counterpart of monai_tpu/data/folder_layout.py):
``{output_dir}/{subject}/{subject}_{postfix}{ext}``, the subject being the input file's
name without its extensions."""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["FolderLayout", "create_file_basename"]


def create_file_basename(postfix: str, input_file_name: str, folder_path: str, data_root_dir: str = "",
                         separate_folder: bool = True, patch_index=None, makedirs: bool = True) -> str:
    """``folder_path/[input's folder relative to data_root_dir/][name/]name[_postfix][_patch]``,
    ``name`` the input file's name without ``.gz`` and one more extension; with
    ``makedirs`` its folder is made."""
    filedir, filename = os.path.split(input_file_name)
    filename, ext = os.path.splitext(filename)
    if ext == ".gz":
        filename, _ = os.path.splitext(filename)
    folder = Path(folder_path)
    if data_root_dir and filedir:
        folder = folder / os.path.relpath(filedir, data_root_dir)
    if separate_folder:
        folder = folder / filename
    if makedirs:
        folder.mkdir(parents=True, exist_ok=True)
    out = str(folder / filename)
    if postfix:
        out += f"_{postfix}"
    if patch_index is not None:
        out += f"_{patch_index}"
    return out


class FolderLayout:
    """Output file names under ``output_dir``: with ``parent`` each subject in a folder
    of its own, ``postfix`` after the subject, ``extension`` at the end."""

    def __init__(self, output_dir: str, postfix: str = "", extension: str = "", parent: bool = False,
                 makedirs: bool = False, data_root_dir: str = ""):
        self.output_dir = output_dir
        self.postfix = postfix
        self.ext = extension
        self.parent = parent
        self.makedirs = makedirs
        self.data_root_dir = data_root_dir

    def filename(self, subject: str = "subject", idx=None, **kwargs) -> str:
        """The file name for ``subject`` (and patch ``idx``); each ``kwargs`` pair adds
        ``_key-value``."""
        name = create_file_basename(self.postfix, subject, self.output_dir, self.data_root_dir, self.parent, idx,
                                    self.makedirs)
        name += "".join(f"_{k}-{v}" for k, v in kwargs.items())
        if self.ext:
            name += self.ext if self.ext.startswith(".") else f".{self.ext}"
        return name
