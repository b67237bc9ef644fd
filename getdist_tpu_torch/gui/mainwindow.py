"""Qt desktop GUI (requires PySide6; the streamlit app is the no-install
alternative). The port's own copy of ``getdist_tpu/gui/mainwindow.py``.

Follows the reference GUI's architecture (``getdist/gui/mainwindow.py``):
the user configures roots/parameters/plot type, the app generates a
runnable python plot script (shown with syntax highlighting, exportable),
and executes that script for the preview — so every plot is reproducible
outside the GUI. Capabilities mirrored from the reference: directory and
grid browsing with recent-directory memory (``mainwindow.py:406-674``),
ordered root selection with move-up/down, stats dialog windows for
marge/like/converge/PCA/LaTeX tables (``:827-941``), an analysis-settings
editor over the full defaults schema (``:950-1130``), plot-option toggles,
a script preview pane built on :mod:`getdist_tpu_torch.gui.plot_script`
(``:1637-1760``), and QSettings window/directory persistence (``:691-728``).

All state logic lives in :mod:`getdist_tpu_torch.gui.app_logic`
(GuiSession, on the torch device given to :func:`run_gui`: the card unless
the caller names the CPU); this module is Qt rendering only, importable
without PySide6.
"""

import os
import sys


def run_gui(args=None, device="cuda"):
    """Launch the Qt GUI on ``device``; prints install guidance and returns
    1 if PySide6 is missing."""
    try:
        from PySide6.QtWidgets import QApplication
    except ImportError:
        print(
            "The desktop GUI requires PySide6 (pip install PySide6).\n"
            "Alternatively run the web GUI: getdist-tpu-torch-streamlit <chain_dir>"
        )
        return 1
    app = QApplication(sys.argv if args is None else args)
    window = MainWindow(device=device)
    window.show()
    return app.exec()


try:
    from PySide6.QtCore import QSettings
    from PySide6.QtWidgets import (
        QCheckBox,
        QComboBox,
        QDialog,
        QDialogButtonBox,
        QDoubleSpinBox,
        QFileDialog,
        QFormLayout,
        QHBoxLayout,
        QLabel,
        QLineEdit,
        QListWidget,
        QListWidgetItem,
        QMainWindow,
        QMessageBox,
        QPlainTextEdit,
        QPushButton,
        QSpinBox,
        QSplitter,
        QTabWidget,
        QVBoxLayout,
        QWidget,
    )

    _HAVE_QT = True
except ImportError:  # pragma: no cover - environment without Qt
    _HAVE_QT = False
    QMainWindow = object
    QDialog = object


if _HAVE_QT:
    from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg

    from getdist_tpu_torch.gui.app_logic import PLOT_TYPES, GuiSession, PlotSpec, analysis_settings_schema
    from getdist_tpu_torch.gui.SyntaxHighlight import PythonHighlighter

    class TextDialog(QDialog):
        """Monospace text viewer window used by every stats action."""

        def __init__(self, parent, title, text, latex=False):
            super().__init__(parent)
            self.setWindowTitle(title)
            self.resize(700, 500)
            layout = QVBoxLayout(self)
            view = QPlainTextEdit()
            view.setReadOnly(True)
            view.setPlainText(text)
            if latex:
                PythonHighlighter(view.document())
            layout.addWidget(view)
            buttons = QDialogButtonBox(QDialogButtonBox.Close)
            buttons.rejected.connect(self.reject)
            buttons.clicked.connect(self.accept)
            layout.addWidget(buttons)

    class ParamTableDialog(QDialog):
        """Parameter-table viewer: one tab per confidence limit, with
        copy-to-clipboard and save-as-.tex actions (role of the reference's
        DialogParamTables, mainwindow.py:893-931 + 2279-2313)."""

        def __init__(self, parent, root, tabs):
            super().__init__(parent)
            self.setWindowTitle(f"Parameter tables: {root}")
            self.resize(760, 560)
            layout = QVBoxLayout(self)
            self.tabs = QTabWidget()
            self._texts = []
            for label, tex in tabs:
                view = QPlainTextEdit()
                view.setReadOnly(True)
                view.setPlainText(tex)
                self.tabs.addTab(view, label)
                self._texts.append(tex)
            layout.addWidget(self.tabs)
            row = QHBoxLayout()
            copy_btn = QPushButton("Copy LaTeX")
            copy_btn.clicked.connect(self.copy_latex)
            save_btn = QPushButton("Save LaTeX...")
            save_btn.clicked.connect(self.save_latex)
            close_btn = QPushButton("Close")
            close_btn.clicked.connect(self.accept)
            for btn in (copy_btn, save_btn, close_btn):
                row.addWidget(btn)
            layout.addLayout(row)

        def current_tex(self):
            return self._texts[self.tabs.currentIndex()] if self._texts else ""

        def copy_latex(self):
            from PySide6.QtWidgets import QApplication

            QApplication.clipboard().setText(self.current_tex())

        def save_latex(self):
            fname, _ = QFileDialog.getSaveFileName(self, "Save LaTeX table", "", "LaTeX (*.tex)")
            if fname:
                with open(fname, "w", encoding="utf-8") as handle:
                    handle.write(self.current_tex())

    class ConfigDialog(QDialog):
        """GUI configuration: plot style module, preview DPI scale, and
        default export format (role of the reference's showConfigSettings,
        mainwindow.py:1092-1130)."""

        STYLES = (
            ("default", None),
            ("planck", "getdist_tpu_torch.styles.planck"),
            ("tab10", "getdist_tpu_torch.styles.tab10"),
        )

        def __init__(self, parent, plot_module, export_format="pdf"):
            super().__init__(parent)
            self.setWindowTitle("Configuration")
            form = QFormLayout(self)
            self.style_box = QComboBox()
            for label, module in self.STYLES:
                self.style_box.addItem(label, module)
                if module == plot_module:
                    self.style_box.setCurrentIndex(self.style_box.count() - 1)
            form.addRow("Plot style module", self.style_box)
            self.format_box = QComboBox()
            self.format_box.addItems(["pdf", "png", "svg"])
            self.format_box.setCurrentText(export_format)
            form.addRow("Default export format", self.format_box)
            buttons = QDialogButtonBox(QDialogButtonBox.Ok | QDialogButtonBox.Cancel)
            buttons.accepted.connect(self.accept)
            buttons.rejected.connect(self.reject)
            form.addRow(buttons)

        def values(self):
            return self.style_box.currentData(), self.format_box.currentText()

    class SettingsDialog(QDialog):
        """Schema-driven settings editor used for BOTH the analysis settings
        (role of reference mainwindow.py:950-1050) and the plot-style
        settings (``:993-1058``): pass the schema and the current override
        dict."""

        def __init__(self, parent, current, schema=None, title="Analysis settings"):
            super().__init__(parent)
            self.setWindowTitle(title)
            self.resize(480, 640)
            outer = QVBoxLayout(self)
            form_host = QWidget()
            form = QFormLayout(form_host)
            self._editors = {}
            self._schema = schema if schema is not None else analysis_settings_schema()
            for fieldspec in self._schema:
                value = current.get(fieldspec.name, fieldspec.default)
                if fieldspec.type is bool:
                    editor = QCheckBox()
                    editor.setChecked(bool(value))
                elif fieldspec.type is int:
                    editor = QSpinBox()
                    editor.setRange(-(10**9), 10**9)
                    editor.setValue(int(value))
                elif fieldspec.type is float:
                    editor = QDoubleSpinBox()
                    editor.setRange(-1e30, 1e30)
                    editor.setDecimals(6)
                    editor.setValue(float(value))
                else:
                    editor = QLineEdit(str(value))
                if fieldspec.help:
                    editor.setToolTip(fieldspec.help)
                form.addRow(fieldspec.name, editor)
                self._editors[fieldspec.name] = (editor, fieldspec)
            from PySide6.QtWidgets import QScrollArea

            scroll = QScrollArea()
            scroll.setWidget(form_host)
            scroll.setWidgetResizable(True)
            outer.addWidget(scroll)
            buttons = QDialogButtonBox(QDialogButtonBox.Ok | QDialogButtonBox.Cancel | QDialogButtonBox.Reset)
            buttons.accepted.connect(self.accept)
            buttons.rejected.connect(self.reject)
            buttons.button(QDialogButtonBox.Reset).clicked.connect(self._reset)
            outer.addWidget(buttons)

        def _reset(self):
            for editor, fieldspec in self._editors.values():
                if fieldspec.type is bool:
                    editor.setChecked(bool(fieldspec.default))
                elif fieldspec.type in (int, float):
                    editor.setValue(fieldspec.default)
                else:
                    editor.setText(str(fieldspec.default))

        def overrides(self):
            """Settings differing from the packaged defaults."""
            out = {}
            for name, (editor, fieldspec) in self._editors.items():
                if fieldspec.type is bool:
                    value = editor.isChecked()
                elif fieldspec.type in (int, float):
                    value = editor.value()
                else:
                    value = editor.text()
                if value != fieldspec.default:
                    out[name] = value
            return out

    class MainWindow(QMainWindow):
        """Main GUI window: directory/grid browser, ordered root selection,
        plot builder with script preview, stats dialogs, settings editor."""

        def __init__(self, device="cuda"):
            super().__init__()
            self.setWindowTitle("GetDist-TPU GUI (PyTorch)")
            self.session = GuiSession(device=device)
            self.settings = QSettings("getdist_tpu_torch", "gui")
            geometry = self.settings.value("geometry")
            if geometry is not None:
                self.restoreGeometry(geometry)
            else:
                self.resize(1200, 800)
            self.export_format = str(self.settings.value("export_format", "pdf"))

            self._build_menus()
            self._build_body()
            self.statusBar().showMessage("Open a chain directory to begin", 5000)
            self.current_fig = None
            self._plot_count = 0
            self.setAcceptDrops(True)
            last_dir = self.settings.value("last_dir")
            if last_dir and os.path.isdir(str(last_dir)):
                self._open_path(str(last_dir))

        # -- drag & drop (reference mainwindow.py:125-130) --------------------

        def dragEnterEvent(self, event):  # noqa: N802 - Qt naming
            if event.mimeData().hasUrls():
                event.acceptProposedAction()

        def dropEvent(self, event):  # noqa: N802 - Qt naming
            for url in event.mimeData().urls():
                path = url.toLocalFile()
                if os.path.isdir(path):
                    self._open_path(path)
                    return

        # -- construction ---------------------------------------------------

        def _build_menus(self):
            bar = self.menuBar()
            file_menu = bar.addMenu("&File")
            file_menu.addAction("Open chain directory...", self.open_directory)
            self.recent_menu = file_menu.addMenu("Recent directories")
            self._fill_recent_menu()
            file_menu.addAction("Re-load files", self.reload_files)
            file_menu.addSeparator()
            file_menu.addAction("Export figure...", self.export_figure)
            file_menu.addAction("Copy figure to clipboard", self.export_clipboard)
            file_menu.addSeparator()
            file_menu.addAction("Open script...", self.open_script)
            file_menu.addAction("Export script...", self.export_script)
            file_menu.addAction("Clear script", self.clear_script)
            file_menu.addSeparator()
            file_menu.addAction("Quit", self.close)

            data_menu = bar.addMenu("&Data")
            data_menu.addAction("Marge stats", lambda: self.show_stats("marge"))
            data_menu.addAction("Like stats", lambda: self.show_stats("like"))
            data_menu.addAction("Converge stats", lambda: self.show_stats("converge"))
            data_menu.addAction("Parameter PCA", lambda: self.show_stats("pca"))
            data_menu.addAction("Parameter tables (LaTeX)", lambda: self.show_stats("table"))

            options_menu = bar.addMenu("&Options")
            options_menu.addAction("Analysis settings...", self.edit_settings)
            options_menu.addAction("Plot settings...", self.edit_plot_settings)
            options_menu.addAction("Reset plot settings", lambda: self.session.reset_plot_settings())
            options_menu.addAction("Configuration...", self.edit_config)
            self.style_menu = options_menu.addMenu("Plot style module")
            for label, module in (
                ("default", None),
                ("planck", "getdist_tpu_torch.styles.planck"),
                ("tab10", "getdist_tpu_torch.styles.tab10"),
            ):
                self.style_menu.addAction(label, lambda m=module: self.set_style(m))

            windows_menu = bar.addMenu("&Windows")
            windows_menu.addAction("Close all plot tabs", self.close_plots)

            help_menu = bar.addMenu("&Help")
            help_menu.addAction("Documentation", lambda: self._open_url("https://getdist.readthedocs.io/"))
            help_menu.addAction("GetDist on GitHub", lambda: self._open_url("https://github.com/cmbant/getdist"))
            help_menu.addAction("About", self.show_about)

        @staticmethod
        def _open_url(url):
            from PySide6.QtCore import QUrl
            from PySide6.QtGui import QDesktopServices

            QDesktopServices.openUrl(QUrl(url))

        def _build_body(self):
            central = QSplitter()
            self.setCentralWidget(central)

            controls = QWidget()
            controls_layout = QVBoxLayout(controls)
            self.grid_tag = QComboBox()
            self.grid_tag.currentTextChanged.connect(self._grid_tag_changed)
            self.grid_tag.hide()
            controls_layout.addWidget(self.grid_tag)
            # second grid-browsing level: data-combination tag under the
            # selected param tag (reference setParamTag/setDataTag)
            self.data_tag = QComboBox()
            self.data_tag.currentTextChanged.connect(self._data_tag_changed)
            self.data_tag.hide()
            controls_layout.addWidget(self.data_tag)
            controls_layout.addWidget(QLabel("Available roots:"))
            self.root_list = QListWidget()
            self.root_list.itemDoubleClicked.connect(lambda item: self.add_root(item.text()))
            controls_layout.addWidget(self.root_list)
            add_row = QHBoxLayout()
            add_btn = QPushButton("Add")
            add_btn.clicked.connect(lambda: [self.add_root(i.text()) for i in self.root_list.selectedItems()])
            add_row.addWidget(add_btn)
            controls_layout.addLayout(add_row)

            controls_layout.addWidget(QLabel("Selected roots (ordered; drag to reorder):"))
            self.selected_list = QListWidget()
            # drag-reorder (reference root list behavior): rows move inside
            # the widget and the session order resyncs from the widget
            self.selected_list.setDragDropMode(QListWidget.DragDropMode.InternalMove)
            self.selected_list.model().rowsMoved.connect(self._roots_reordered)
            controls_layout.addWidget(self.selected_list)
            order_row = QHBoxLayout()
            for label, action in (
                ("Up", lambda: self.move_selected(-1)),
                ("Down", lambda: self.move_selected(+1)),
                ("Remove", self.remove_selected),
            ):
                btn = QPushButton(label)
                btn.clicked.connect(action)
                order_row.addWidget(btn)
            controls_layout.addLayout(order_row)

            x_row = QHBoxLayout()
            x_row.addWidget(QLabel("X parameters:"))
            self.x_select_all = QCheckBox("all")
            self.x_select_all.toggled.connect(self._toggle_all_x)
            x_row.addWidget(self.x_select_all)
            controls_layout.addLayout(x_row)
            self.param_list = QListWidget()
            self.param_list.setSelectionMode(QListWidget.ExtendedSelection)
            controls_layout.addWidget(self.param_list)
            controls_layout.addWidget(QLabel("Y parameters (rectangle):"))
            self.y_param_list = QListWidget()
            self.y_param_list.setSelectionMode(QListWidget.ExtendedSelection)
            controls_layout.addWidget(self.y_param_list)
            controls_layout.addWidget(QLabel("Color parameter (3d):"))
            self.z_param = QComboBox()
            self.z_param.addItem("(none)")
            controls_layout.addWidget(self.z_param)

            controls_layout.addWidget(QLabel("Plot type:"))
            self.plot_type = QComboBox()
            self.plot_type.addItems(list(PLOT_TYPES))
            controls_layout.addWidget(self.plot_type)
            toggles = QHBoxLayout()
            self.filled_box = QCheckBox("Filled")
            self.filled_box.setChecked(True)
            self.shaded_box = QCheckBox("Shaded")
            self.normalized_box = QCheckBox("Normalized")
            for box in (self.filled_box, self.shaded_box, self.normalized_box):
                toggles.addWidget(box)
            controls_layout.addLayout(toggles)
            plot_btn = QPushButton("Make plot")
            plot_btn.clicked.connect(self.make_plot)
            controls_layout.addWidget(plot_btn)
            central.addWidget(controls)

            # plot tabs: every Make plot opens a new closable tab (the
            # reference keeps multiple plot outputs, mainwindow.py:1918-1968);
            # the script tab is pinned and not closable
            self.tabs = QTabWidget()
            self.tabs.setTabsClosable(True)
            self.tabs.tabCloseRequested.connect(self._close_tab)
            # editable script pane: edits are re-executed for the preview
            # (the reference GUI's script-tab workflow, mainwindow.py:1637+)
            script_host = QWidget()
            script_layout = QVBoxLayout(script_host)
            self.script_edit = QPlainTextEdit()
            PythonHighlighter(self.script_edit.document())
            script_layout.addWidget(self.script_edit)
            run_script_btn = QPushButton("Run script for preview")
            run_script_btn.clicked.connect(self.run_edited_script)
            script_layout.addWidget(run_script_btn)
            self.tabs.addTab(script_host, "Script")
            if hasattr(self.tabs, "tabBar"):
                bar = self.tabs.tabBar()
                bar.setTabButton(0, bar.ButtonPosition.RightSide, None)
                bar.setTabButton(0, bar.ButtonPosition.LeftSide, None)
            central.addWidget(self.tabs)
            central.setSizes([320, 880])

        def _toggle_all_x(self, checked):
            self.param_list.selectAll() if checked else self.param_list.clearSelection()

        def _close_tab(self, index):
            widget = self.tabs.widget(index)
            if widget is None or self.tabs.tabText(index) == "Script":
                return
            self.tabs.removeTab(index)
            widget.deleteLater()

        def close_plots(self):
            """Close every plot tab, keeping the pinned script tab."""
            for index in reversed(range(self.tabs.count())):
                if self.tabs.tabText(index) != "Script":
                    self._close_tab(index)
            self.current_fig = None

        # -- persistence -----------------------------------------------------

        def closeEvent(self, event):  # noqa: N802 - Qt naming
            self.settings.setValue("geometry", self.saveGeometry())
            if self.session.chain_dir:
                self.settings.setValue("last_dir", self.session.chain_dir)
            super().closeEvent(event)

        def _fill_recent_menu(self):
            from getdist_tpu_torch.gui.app_logic import load_recent_dirs

            self.recent_menu.clear()
            for directory in load_recent_dirs():
                self.recent_menu.addAction(directory, lambda d=directory: self._open_path(d))

        # -- directory handling ------------------------------------------------

        def open_directory(self):
            directory = QFileDialog.getExistingDirectory(self, "Open chain directory")
            if directory:
                self._open_path(directory)

        def _open_path(self, directory):
            try:
                self.session.open_directory(directory)
            except Exception as e:
                QMessageBox.critical(self, "Open failed", str(e))
                return
            self.settings.setValue("last_dir", directory)
            self._fill_recent_menu()
            if self.session.is_grid():
                self.grid_tag.show()
                self.grid_tag.clear()
                self.grid_tag.addItems(["(all)"] + self.session.param_tags())
            else:
                self.grid_tag.hide()
                self.data_tag.hide()
            self._refresh_roots(self.session.available_roots())
            self.statusBar().showMessage(f"Opened {directory}", 5000)

        def _grid_tag_changed(self, tag):
            if not self.session.is_grid() or not tag:
                return
            if tag == "(all)":
                self.data_tag.hide()
                self._refresh_roots(self.session.available_roots())
                return
            self.data_tag.blockSignals(True)
            self.data_tag.clear()
            self.data_tag.addItems(["(all data)"] + self.session.data_tags(tag))
            self.data_tag.blockSignals(False)
            self.data_tag.show()
            self._refresh_roots(self.session.roots_for_tag(tag))

        def _data_tag_changed(self, datatag):
            tag = self.grid_tag.currentText()
            if not self.session.is_grid() or not tag or tag == "(all)" or not datatag:
                return
            roots = self.session.roots_for_tag(tag, None if datatag == "(all data)" else datatag)
            self._refresh_roots(roots)

        def _refresh_roots(self, roots):
            self.root_list.clear()
            for root in roots:
                QListWidgetItem(root, self.root_list)
            self.selected_list.clear()
            self.session.root_order = []
            self.param_list.clear()
            self.y_param_list.clear()

        def reload_files(self):
            self.session.reload_files()
            self.update_params()

        # -- root selection ----------------------------------------------------

        def add_root(self, root):
            self.session.add_root(root)
            self._sync_selected()
            self.update_params()

        def remove_selected(self):
            for item in self.selected_list.selectedItems():
                self.session.remove_root(item.text())
            self._sync_selected()
            self.update_params()

        def move_selected(self, delta):
            items = self.selected_list.selectedItems()
            if items:
                self.session.move_root(items[0].text(), delta)
                self._sync_selected()

        def _sync_selected(self):
            self.selected_list.clear()
            for root in self.session.root_order:
                QListWidgetItem(root, self.selected_list)

        def _roots_reordered(self, *args):
            """After a drag-reorder, the widget order is the truth."""
            order = [self.selected_list.item(i).text() for i in range(self.selected_list.count())]
            self.session.root_order = [r for r in order if r in self.session.root_order]

        def update_params(self):
            self.param_list.clear()
            self.y_param_list.clear()
            self.z_param.clear()
            self.z_param.addItem("(none)")
            if self.session.root_order:
                for name in self.session.param_list():
                    QListWidgetItem(name, self.param_list)
                    QListWidgetItem(name, self.y_param_list)
                    self.z_param.addItem(name)

        def selected_params(self, which=None):
            host = self.y_param_list if which == "y" else self.param_list
            return [item.text() for item in host.selectedItems()]

        # -- plotting --------------------------------------------------------------

        def _current_spec(self):
            color = self.z_param.currentText()
            return PlotSpec(
                plot_type=self.plot_type.currentText(),
                x_params=self.selected_params(),
                y_params=self.selected_params("y"),
                color_param=None if color in ("", "(none)") else color,
                filled=self.filled_box.isChecked(),
                shaded=self.shaded_box.isChecked(),
                normalized=self.normalized_box.isChecked(),
            )

        def make_plot(self):
            if not self.session.root_order:
                QMessageBox.warning(self, "GetDist-TPU", "Add root(s) first")
                return
            spec = self._current_spec()
            issues = spec.problems()
            if issues:
                QMessageBox.warning(self, "GetDist-TPU", "; ".join(issues))
                return
            self.statusBar().showMessage("Generating plot...")
            try:
                fig, script = self.session.make_figure(spec)
            except Exception as e:
                self.statusBar().clearMessage()
                QMessageBox.critical(self, "Plot failed", str(e))
                return
            self.statusBar().showMessage("Done", 3000)
            self.script_edit.setPlainText(script)
            self._show_figure(fig)

        def _show_figure(self, fig, title=None):
            """Show a figure in a NEW closable plot tab (the script tab is
            pinned); the newest figure becomes the export target."""
            self.current_fig = fig
            holder = QWidget()
            layout = QVBoxLayout(holder)
            layout.addWidget(FigureCanvasQTAgg(fig))
            self._plot_count += 1
            index = self.tabs.addTab(holder, title or f"Plot {self._plot_count}")
            self.tabs.setCurrentIndex(index)

        # -- stats dialogs ------------------------------------------------------------

        def show_stats(self, which):
            if not self.session.root_order:
                QMessageBox.warning(self, "GetDist-TPU", "Add root(s) first")
                return
            root = self.session.root_order[0]
            try:
                if which == "marge":
                    TextDialog(self, f"Marge stats: {root}", self.session.marge_stats(root)).exec()
                elif which == "like":
                    TextDialog(self, f"Like stats: {root}", self.session.like_stats(root)).exec()
                elif which == "converge":
                    TextDialog(self, f"Convergence: {root}", self.session.converge_stats(root)).exec()
                elif which == "pca":
                    params = self.selected_params() or self.session.param_list()[:2]
                    if len(params) < 2:
                        QMessageBox.warning(self, "GetDist-TPU", "Select two or more parameters for PCA")
                        return
                    TextDialog(self, f"PCA: {root}", self.session.pca_report(root, params)).exec()
                elif which == "table":
                    params = self.selected_params() or None
                    ParamTableDialog(self, root, self.session.param_table_tabs(root, params)).exec()
            except Exception as e:
                QMessageBox.critical(self, "Statistics failed", str(e))

        # -- options --------------------------------------------------------------------

        def edit_settings(self):
            dialog = SettingsDialog(self, self.session.analysis_settings)
            if dialog.exec() == QDialog.Accepted:
                from getdist_tpu_torch.gui.app_logic import update_script_analysis_settings

                self.session.apply_analysis_settings(dialog.overrides())
                self.update_params()
                # keep the script pane in sync (reference settingsChanged)
                text = self.script_edit.toPlainText()
                if text:
                    self.script_edit.setPlainText(
                        update_script_analysis_settings(text, self.session.analysis_settings)
                    )
                if self.current_fig is not None:
                    self.make_plot()

        def edit_plot_settings(self):
            """Plot-style settings editor over the full GetDistPlotSettings
            schema; overrides update the session, the script pane, and the
            live preview (role of reference mainwindow.py:993-1090)."""
            from getdist_tpu_torch.gui.app_logic import (
                parse_plot_setting,
                plot_settings_schema,
                update_script_plot_settings,
            )

            schema = plot_settings_schema()
            current = {k: str(v) for k, v in self.session.custom_plot_settings.items()}
            dialog = SettingsDialog(self, current, schema=schema, title="Plot settings")
            if dialog.exec() != QDialog.Accepted:
                return
            overrides = {}
            by_name = {f.name: f for f in schema}
            try:
                for key, raw in dialog.overrides().items():
                    overrides[key] = parse_plot_setting(by_name[key], str(raw))
            except Exception as e:
                QMessageBox.critical(self, "Plot settings", str(e))
                return
            self.session.apply_plot_settings(overrides)
            text = self.script_edit.toPlainText()
            if text:
                self.script_edit.setPlainText(update_script_plot_settings(text, overrides))
            if self.current_fig is not None:
                self.run_edited_script() if text else self.make_plot()

        def run_edited_script(self):
            """Execute the (possibly edited) script pane text for the
            preview — edits are honored, not regenerated away."""
            text = self.script_edit.toPlainText()
            if not text:
                return
            try:
                fig = self.session.run_script(text)
            except Exception as e:
                QMessageBox.critical(self, "Script failed", str(e))
                return
            self._show_figure(fig)

        def set_style(self, module):
            self.session.set_plot_module(module)

        def edit_config(self):
            """GUI configuration dialog (style module + default export
            format), persisted via QSettings."""
            dialog = ConfigDialog(self, self.session.plot_module, self.export_format)
            if dialog.exec() != QDialog.Accepted:
                return
            module, export_format = dialog.values()
            self.session.set_plot_module(module)
            self.export_format = export_format
            self.settings.setValue("export_format", export_format)

        def show_about(self):
            import getdist_tpu_torch

            QMessageBox.about(
                self,
                "GetDist-TPU",
                f"GetDist-TPU, PyTorch port {getdist_tpu_torch.__version__}\n"
                f"MCMC sample analysis on {self.session.device}.",
            )

        # -- export ------------------------------------------------------------------------

        def export_figure(self):
            if self.current_fig is None:
                return
            filters = {"pdf": "PDF (*.pdf)", "png": "PNG (*.png)", "svg": "SVG (*.svg)"}
            order = [filters.pop(self.export_format, "PDF (*.pdf)")] + list(filters.values())
            fname, _ = QFileDialog.getSaveFileName(self, "Export figure", "", ";;".join(order))
            if fname:
                self.current_fig.savefig(fname, bbox_inches="tight")
                self.statusBar().showMessage(f"Saved {fname}", 5000)

        def export_clipboard(self):
            """Copy the current figure to the system clipboard as an image
            (reference export_clipboard, mainwindow.py:775-781)."""
            if self.current_fig is None:
                return
            import io

            from PySide6.QtGui import QImage
            from PySide6.QtWidgets import QApplication

            buf = io.BytesIO()
            self.current_fig.savefig(buf, format="png", dpi=150, bbox_inches="tight")
            image = QImage.fromData(buf.getvalue(), "PNG")
            QApplication.clipboard().setImage(image)
            self.statusBar().showMessage("Figure copied to clipboard", 3000)

        def export_script(self):
            text = self.script_edit.toPlainText()
            if not text:
                return
            fname, _ = QFileDialog.getSaveFileName(self, "Export script", "", "Python (*.py)")
            if fname:
                with open(fname, "w", encoding="utf-8") as handle:
                    handle.write(text)
                self.statusBar().showMessage(f"Saved {fname}", 5000)

        def open_script(self):
            """Load a plot script from disk into the editable script pane
            (reference openScript, mainwindow.py:1970-1984)."""
            fname, _ = QFileDialog.getOpenFileName(self, "Open script", "", "Python (*.py)")
            if not fname:
                return
            with open(fname, encoding="utf-8") as handle:
                self.script_edit.setPlainText(handle.read())
            self.tabs.setCurrentWidget(self.script_edit.parentWidget())

        def clear_script(self):
            self.script_edit.clear()


if __name__ == "__main__":
    sys.exit(run_gui())
